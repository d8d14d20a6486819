"""Key=value config parser with includes, overrides, and unused-key warnings.

The port's copy of `katacoffee_tpu/utils/config.py` (pure Python, kept here
so the port imports nothing of the JAX package), the behavioral equivalent
of the reference's `cpp/core/config_parser.{h,cpp}` (ConfigParser,
config_parser.h:19): `key = value` lines, `#` comments, `@include file`
directives resolved relative to the including file with circular-include
detection, later keys override earlier ones, `-override-config k=v,k=v`
style override strings, typed getters with range checks, and warnings for
keys that were never read (config_parser.h:47; used e.g. at
cpp/command/selfplay.cpp:266).
"""

from __future__ import annotations

import os
from typing import Iterable


class ConfigError(ValueError):
    pass


_TRUE = {"true", "True", "1"}
_FALSE = {"false", "False", "0"}


class ConfigParser:
    def __init__(
        self,
        path: str | None = None,
        text: str | None = None,
        overrides: str | dict | None = None,
    ):
        self._kvs: dict[str, str] = {}
        self._origin: dict[str, str] = {}
        self._used: set[str] = set()
        self._files: list[str] = []
        if path is not None:
            self._parse_file(path, stack=())
        if text is not None:
            self._parse_text(text, origin="<text>", stack=())
        if overrides:
            self.apply_overrides(overrides)

    # -- parsing ------------------------------------------------------------

    def _parse_file(self, path: str, stack: tuple):
        apath = os.path.abspath(path)
        if apath in stack:
            chain = " -> ".join(list(stack) + [apath])
            raise ConfigError(f"Circular config include: {chain}")
        if not os.path.exists(apath):
            raise ConfigError(f"Config file not found: {path}")
        self._files.append(apath)
        with open(apath, "r") as f:
            self._parse_text(f.read(), origin=apath, stack=stack + (apath,))

    def _parse_text(self, text: str, origin: str, stack: tuple):
        for lineno, raw in enumerate(text.splitlines(), 1):
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            if line.startswith("@include"):
                inc = line[len("@include") :].strip()
                if not inc:
                    raise ConfigError(f"{origin}:{lineno}: @include with no file")
                base = os.path.dirname(origin) if os.path.exists(origin) else "."
                self._parse_file(os.path.join(base, inc), stack)
                continue
            if "=" not in line:
                raise ConfigError(f"{origin}:{lineno}: expected key = value, got: {raw!r}")
            key, val = line.split("=", 1)
            key = key.strip()
            val = val.strip()
            if not key:
                raise ConfigError(f"{origin}:{lineno}: empty key")
            self._kvs[key] = val
            self._origin[key] = f"{origin}:{lineno}"

    def apply_overrides(self, overrides: str | dict):
        """`k=v,k=v` string (the reference's -override-config) or a dict."""
        if isinstance(overrides, dict):
            items = overrides.items()
        else:
            items = []
            for part in overrides.split(","):
                part = part.strip()
                if not part:
                    continue
                if "=" not in part:
                    raise ConfigError(f"Bad override (want k=v): {part!r}")
                k, v = part.split("=", 1)
                items.append((k.strip(), v.strip()))
        for k, v in items:
            self._kvs[k] = str(v)
            self._origin[k] = "<override>"

    # -- getters ------------------------------------------------------------

    def contains(self, key: str) -> bool:
        return key in self._kvs

    __contains__ = contains

    def keys(self) -> list[str]:
        return list(self._kvs.keys())

    def get_string(self, key: str, default: str | None = None, allowed: Iterable[str] | None = None) -> str:
        if key not in self._kvs:
            if default is None:
                raise ConfigError(f"Config missing required key: {key}")
            return default
        self._used.add(key)
        v = self._kvs[key]
        if allowed is not None and v not in set(allowed):
            raise ConfigError(f"{key} = {v!r} not in allowed values {sorted(allowed)}")
        return v

    def get_int(self, key: str, default: int | None = None, min: int | None = None, max: int | None = None) -> int:
        if key not in self._kvs:
            if default is None:
                raise ConfigError(f"Config missing required key: {key}")
            return default
        self._used.add(key)
        try:
            v = int(self._kvs[key])
        except ValueError:
            raise ConfigError(f"{key} = {self._kvs[key]!r} is not an int ({self._origin[key]})")
        if min is not None and v < min:
            raise ConfigError(f"{key} = {v} below minimum {min}")
        if max is not None and v > max:
            raise ConfigError(f"{key} = {v} above maximum {max}")
        return v

    def get_float(self, key: str, default: float | None = None, min: float | None = None, max: float | None = None) -> float:
        if key not in self._kvs:
            if default is None:
                raise ConfigError(f"Config missing required key: {key}")
            return default
        self._used.add(key)
        try:
            v = float(self._kvs[key])
        except ValueError:
            raise ConfigError(f"{key} = {self._kvs[key]!r} is not a float ({self._origin[key]})")
        if min is not None and v < min:
            raise ConfigError(f"{key} = {v} below minimum {min}")
        if max is not None and v > max:
            raise ConfigError(f"{key} = {v} above maximum {max}")
        return v

    def get_bool(self, key: str, default: bool | None = None) -> bool:
        if key not in self._kvs:
            if default is None:
                raise ConfigError(f"Config missing required key: {key}")
            return default
        self._used.add(key)
        v = self._kvs[key]
        if v in _TRUE:
            return True
        if v in _FALSE:
            return False
        raise ConfigError(f"{key} = {v!r} is not a bool ({self._origin[key]})")

    def get_ints(self, key: str, default: list[int] | None = None) -> list[int]:
        if key not in self._kvs:
            if default is None:
                raise ConfigError(f"Config missing required key: {key}")
            return default
        self._used.add(key)
        raw = self._kvs[key].replace(",", " ").split()
        return [int(x) for x in raw]

    # -- warnings -----------------------------------------------------------

    def unused_keys(self) -> list[str]:
        return sorted(k for k in self._kvs if k not in self._used)

    def warn_unused(self, logger=None) -> list[str]:
        unused = self.unused_keys()
        for k in unused:
            msg = f"WARNING: unused config key: {k} (from {self._origin[k]})"
            if logger is not None:
                logger.write(msg)
            else:
                print(msg)
        return unused

    def to_dict(self) -> dict[str, str]:
        return dict(self._kvs)
