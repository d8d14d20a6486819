"""Game orchestration: the port of `katacoffee_tpu/program/`: `setup.py`,
`match.py` (gatekeeper, match, loop) and `engine.py`, the engine facade of
the GTP frontend."""

from katacoffee_tpu_torch.program.setup import load_eval_fn, load_game_config, load_search_params

__all__ = ["load_eval_fn", "load_game_config", "load_search_params"]
