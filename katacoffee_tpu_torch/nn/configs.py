"""Model size menu: the port of `katacoffee_tpu/nn/configs.py`, copied
whole (b<blocks>c<channels>, 'nbt' = nested-bottleneck trunk)."""

from __future__ import annotations

from katacoffee_tpu_torch.nn.model import ModelSpec

_REGISTRY: dict[str, ModelSpec] = {}


def _reg(spec: ModelSpec) -> ModelSpec:
    _REGISTRY[spec.name] = spec
    return spec


b1c6 = _reg(
    ModelSpec(
        name="b1c6",
        trunk_channels=6,
        mid_channels=6,
        gpool_channels=4,
        blocks=("regular",),
        p1_channels=4,
        g1_channels=4,
        v1_channels=4,
        v2_size=6,
    )
)

b2c16 = _reg(
    ModelSpec(
        name="b2c16",
        trunk_channels=16,
        mid_channels=16,
        gpool_channels=8,
        blocks=("regular", "gpool"),
        p1_channels=8,
        g1_channels=8,
        v1_channels=8,
        v2_size=12,
    )
)

b2c32 = _reg(
    ModelSpec(
        name="b2c32",
        trunk_channels=32,
        mid_channels=32,
        gpool_channels=16,
        blocks=("regular", "gpool"),
        p1_channels=16,
        g1_channels=16,
        v1_channels=16,
        v2_size=24,
    )
)

b4c32 = _reg(
    ModelSpec(
        name="b4c32",
        trunk_channels=32,
        mid_channels=32,
        gpool_channels=16,
        blocks=("regular", "regular", "gpool", "regular"),
        p1_channels=16,
        g1_channels=16,
        v1_channels=16,
        v2_size=32,
    )
)

b6c96 = _reg(
    ModelSpec(
        name="b6c96",
        trunk_channels=96,
        mid_channels=96,
        gpool_channels=32,
        blocks=("regular", "regular", "gpool", "regular", "gpool", "regular"),
        p1_channels=32,
        g1_channels=32,
        v1_channels=32,
        v2_size=64,
    )
)

b10c128 = _reg(
    ModelSpec(
        name="b10c128",
        trunk_channels=128,
        mid_channels=128,
        gpool_channels=32,
        blocks=("regular",) * 4 + ("gpool",) + ("regular",) * 3 + ("gpool", "regular"),
        p1_channels=32,
        g1_channels=32,
        v1_channels=48,
        v2_size=80,
    )
)

b10c384nbt = _reg(
    ModelSpec(
        name="b10c384nbt",
        trunk_channels=384,
        mid_channels=192,
        gpool_channels=64,
        blocks=("nbt", "nbt", "gpool", "nbt", "nbt", "gpool", "nbt", "nbt", "gpool", "nbt"),
        p1_channels=64,
        g1_channels=64,
        v1_channels=96,
        v2_size=128,
    )
)

b15c192 = _reg(
    ModelSpec(
        name="b15c192",
        trunk_channels=192,
        mid_channels=192,
        gpool_channels=48,
        blocks=("regular",) * 4 + ("gpool",) + ("regular",) * 4 + ("gpool",) + ("regular",) * 5,
        p1_channels=32,
        g1_channels=32,
        v1_channels=64,
        v2_size=96,
    )
)

b20c256 = _reg(
    ModelSpec(
        name="b20c256",
        trunk_channels=256,
        mid_channels=256,
        gpool_channels=64,
        blocks=("regular",) * 5 + ("gpool",) + ("regular",) * 5 + ("gpool",) + ("regular",) * 4 + ("gpool",) + ("regular",) * 3,
        p1_channels=48,
        g1_channels=48,
        v1_channels=64,
        v2_size=112,
    )
)

b18c384nbt = _reg(
    ModelSpec(
        name="b18c384nbt",
        trunk_channels=384,
        mid_channels=192,
        gpool_channels=64,
        blocks=("nbt",) * 5 + ("gpool",) + ("nbt",) * 5 + ("gpool",) + ("nbt",) * 4 + ("gpool",) + ("nbt",) * 2,
        p1_channels=64,
        g1_channels=64,
        v1_channels=96,
        v2_size=128,
    )
)


def get_model_spec(name: str) -> ModelSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model spec '{name}'; have {sorted(_REGISTRY)}")


def model_names() -> list[str]:
    return sorted(_REGISTRY)
