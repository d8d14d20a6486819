"""KataCoffee in PyTorch and CUDA: the port of `katacoffee_tpu` to one
NVIDIA H100.

The subpackages mirror the JAX package's (`game/`, `nn/`, `ops/`, `search/`,
`selfplay/`, `dataio/`, `command/`, `utils/`) so each module's counterpart is
found by its path; `python -m katacoffee_tpu_torch selfplay` runs the
selfplay daemon.
The port imports torch and numpy only: nothing of JAX, flax or
`katacoffee_tpu`. Entry points run on `cuda` unless the caller passes
`device="cpu"`; the search's interior descent and child-stats gather are
hand-written CUDA kernels (`ops/descend_kernel.cu`, `ops/gather_kernel.cu`)
on the card and plain torch indexing on the CPU.
"""

__version__ = "0.1.0"
