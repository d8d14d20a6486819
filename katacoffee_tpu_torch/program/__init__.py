"""Game orchestration: the port of `katacoffee_tpu/program/` as far as the
gatekeeper, match and loop commands need it (`setup.py`, `match.py`); the
engine facade of the GTP and analysis frontends is not ported yet."""

from katacoffee_tpu_torch.program.setup import load_eval_fn, load_game_config, load_search_params

__all__ = ["load_eval_fn", "load_game_config", "load_search_params"]
