"""The port's copies of the config parser and the logger
(`katacoffee_tpu_torch/utils/`) against the JAX package's: every key of
every `configs/*.cfg` read through both parsers with each typed getter
(values equal, or the same error), overrides, includes, bounds errors and
unused keys; the logger's lines in the same format."""

import glob
import os
import re

import pytest

from katacoffee_tpu.utils import config as JC
from katacoffee_tpu.utils.logger import Logger as JLogger
from katacoffee_tpu_torch.utils import config as TC
from katacoffee_tpu_torch.utils.logger import Logger as TLogger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.cfg")))


def outcome(fn, *args, **kw):
    """("ok", value) or ("error", class name, message)."""
    try:
        return ("ok", fn(*args, **kw))
    except (TC.ConfigError, JC.ConfigError, ValueError) as e:
        return ("error", type(e).__name__, str(e))


def both(*args, **kw):
    return JC.ConfigParser(*args, **kw), TC.ConfigParser(*args, **kw)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_every_key_reads_the_same_through_each_getter(path):
    j, t = both(path)
    assert t.keys() == j.keys() and t.to_dict() == j.to_dict()
    assert t.unused_keys() == j.unused_keys() == sorted(j.keys())
    for key in j.keys():
        for getter in ("get_string", "get_int", "get_float", "get_bool", "get_ints"):
            assert outcome(getattr(t, getter), key) == outcome(getattr(j, getter), key), (key, getter)
        assert t.contains(key) and key in t
    assert t.unused_keys() == j.unused_keys() == []
    for getter, default in (("get_string", "x"), ("get_int", 3), ("get_float", 0.5), ("get_bool", True),
                            ("get_ints", [1, 2])):
        assert getattr(t, getter)("noSuchKey", default) == getattr(j, getter)("noSuchKey", default) == default
        assert outcome(getattr(t, getter), "noSuchKey") == outcome(getattr(j, getter), "noSuchKey")


def test_overrides_includes_bounds_and_unused_keys(tmp_path):
    base = tmp_path / "base.cfg"
    base.write_text("a = 1\nb = 2.5\nflag = true  # comment\nlist = 1, 2 3\nname = katacoffee\n")
    top = tmp_path / "top.cfg"
    top.write_text("@include base.cfg\nb = 7\nextra = yes\n")
    j, t = both(str(top), overrides="a=5, name = other")
    assert t.to_dict() == j.to_dict()
    for key, kw in (("a", dict(min=6)), ("a", dict(max=4)), ("a", dict(min=0, max=9)), ("b", dict(min=8.0)),
                    ("b", dict(max=6.5)), ("name", dict(allowed=("katacoffee", "other"))),
                    ("name", dict(allowed=("x",))), ("flag", {}), ("extra", {})):
        getter = {"a": "get_int", "b": "get_float", "name": "get_string", "flag": "get_bool",
                  "extra": "get_bool"}[key]
        assert outcome(getattr(t, getter), key, **kw) == outcome(getattr(j, getter), key, **kw), (key, kw)
    assert t.get_ints("list") == j.get_ints("list") == [1, 2, 3]
    assert t.unused_keys() == j.unused_keys()
    t.apply_overrides({"c": 3})
    j.apply_overrides({"c": 3})
    assert t.to_dict() == j.to_dict() and t.unused_keys() == j.unused_keys()
    seen_t, seen_j = [], []

    class Sink:
        def __init__(self, out):
            self.out = out

        def write(self, msg):
            self.out.append(msg)

    assert t.warn_unused(Sink(seen_t)) == j.warn_unused(Sink(seen_j))
    assert seen_t == seen_j and seen_t


@pytest.mark.parametrize("text,overrides", [
    ("a 1\n", None),  # no '='
    (" = 1\n", None),  # empty key
    ("@include\n", None),
    ("", "novalue"),
    ("@include missing.cfg\n", None),
])
def test_malformed_input_fails_the_same(text, overrides):
    def make(mod):
        return mod.ConfigParser(text=text, overrides=overrides)

    assert outcome(make, TC) == outcome(make, JC)


def test_circular_include(tmp_path):
    (tmp_path / "x.cfg").write_text("@include y.cfg\n")
    (tmp_path / "y.cfg").write_text("@include x.cfg\n")
    got = outcome(TC.ConfigParser, str(tmp_path / "x.cfg"))
    want = outcome(JC.ConfigParser, str(tmp_path / "x.cfg"))
    assert got == want and got[0] == "error" and "Circular" in got[2]


def test_logger_lines_match(tmp_path, capsys):
    lines = {}
    for name, cls in (("jax", JLogger), ("port", TLogger)):
        log = cls(log_to_stdout=True)
        path = tmp_path / f"{name}.log"
        log.add_file(str(path))
        log.write("selfplay: seg 1 rows 10")
        log.write("second line")
        log.close()
        lines[name] = path.read_text().splitlines()
        out = capsys.readouterr().out.splitlines()
        assert out == lines[name]
    stamp = re.compile(r"^\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}[+-]?\d*: ")
    assert [stamp.sub("", x) for x in lines["port"]] == [stamp.sub("", x) for x in lines["jax"]] == [
        "selfplay: seg 1 rows 10", "second line"]
    assert all(stamp.match(x) for x in lines["port"])
