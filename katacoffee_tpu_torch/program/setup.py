"""Config -> engine objects: the port of `katacoffee_tpu/program/setup.py`
(the reference's `Setup`, `cpp/program/setup.{h,cpp}`): config keys onto
SearchParams (the same key names as searchparams.h, so reference configs
translate), the game config, and evaluators."""

from __future__ import annotations

import dataclasses

import torch

from katacoffee_tpu_torch.game.board import GameConfig
from katacoffee_tpu_torch.search.params import SearchParams
from katacoffee_tpu_torch.utils.config import ConfigParser


def load_game_config(cfg: ConfigParser) -> GameConfig:
    return GameConfig(
        cfg.get_int("xSize", 5, min=2, max=19),
        cfg.get_int("ySize", 5, min=2, max=19),
        cfg.get_int("winLen", 4, min=2),
    )


def load_search_params(cfg: ConfigParser, defaults: SearchParams | None = None) -> SearchParams:
    """Every SearchParams field is a config key (Setup::loadParams,
    setup.cpp:500-800: each known key is read if present, else the
    default)."""
    base = defaults if defaults is not None else SearchParams()
    updates = {}
    for field in dataclasses.fields(SearchParams):
        if not cfg.contains(field.name):
            continue
        if field.type in ("bool", bool):
            updates[field.name] = cfg.get_bool(field.name)
        elif field.type in ("int", int):
            updates[field.name] = cfg.get_int(field.name)
        else:
            updates[field.name] = cfg.get_float(field.name)
    return dataclasses.replace(base, **updates)


def load_eval_fn(cfg: GameConfig, model_dir: str | None, *, device: str | torch.device | None = None):
    """Model dir -> (EvalFn, the model's GameConfig, name), the net on
    `device` (default `cuda`); None -> uniform priors under the name
    "random" (cfg stands for the model's config)."""
    from katacoffee_tpu_torch.search.mcts import make_nn_eval_fn, uniform_eval_fn

    if model_dir is None:
        return uniform_eval_fn(cfg), cfg, "random"
    from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model

    model, mcfg, meta = load_exported_model(model_dir, device=device)
    return make_nn_eval_fn(mcfg, model), mcfg, meta["name"]
