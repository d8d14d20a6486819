from katacoffee_tpu_torch.train.losses import compute_losses
from katacoffee_tpu_torch.train.replay import ReplayBuffer
from katacoffee_tpu_torch.train.train import (
    StepDraws,
    TrainConfig,
    TrainState,
    init_train_state,
    make_sharded_train_step,
    make_train_step,
)
