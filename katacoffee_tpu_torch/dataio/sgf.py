"""SGF reading/writing for Coffee games: the port's copy of
`katacoffee_tpu/dataio/sgf.py` (pure Python; it takes D_NONE from the port's
rules).

Format matches the reference exactly (`cpp/dataio/sgf.cpp`):
  * header `(;FF[4]GM[Coffee]SZ[x]` or `SZ[x:y]`, `WLL[win_len]`,
    `PB`/`PW`, `RE[B+ | W+ | B+R | W+R]` (sgf.cpp:1540-1549,1470-1506);
  * coordinates: chars `a-zA-Z` for x then y (sgf.cpp:55-61,132-143);
  * a move property value is 3 chars — 2 spot chars + a direction char
    `a-d` ↔ directions N `|`, W `—`, NW `\\`, NE `/` (sgf.cpp:63-69,145-149);
  * `AB`/`AW` placements are 2-char spots (used as custom start positions,
    README "Custom SGF");
  * moves as `;B[...]` / `;W[...]` nodes.

One deliberate extension: the reference's writer asserts games never end in a
draw (sgf.cpp:1495-1500 ASSERT_UNREACHABLE) but its BoardHistory explicitly
represents draws (boardhistory.h:28) and our frozen no-legal-move rule makes
them reachable; we write the SGF-standard `RE[0]` for a draw.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Iterable

from katacoffee_tpu_torch.game.board import D_NONE

_COORD_CHARS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
_DIR_CHARS = "abcd"


def _coord_char(v: int) -> str:
    if not 0 <= v < len(_COORD_CHARS):
        raise ValueError(f"coordinate out of SGF range: {v}")
    return _COORD_CHARS[v]


def _parse_coord(c: str) -> int:
    if "a" <= c <= "z":
        return ord(c) - ord("a")
    if "A" <= c <= "Z":
        return ord(c) - ord("A") + 26
    raise ValueError(f"bad SGF coordinate char: {c!r}")


def _parse_dir(c: str) -> int:
    if "a" <= c <= "d":
        return ord(c) - ord("a")
    if "A" <= c <= "D":
        return ord(c) - ord("A")
    raise ValueError(f"bad SGF direction char: {c!r}")


def move_to_sgf(x: int, y: int, direction: int) -> str:
    return _coord_char(x) + _coord_char(y) + _DIR_CHARS[direction]


def sgf_to_move(s: str) -> tuple[int, int, int]:
    """3-char SGF move value -> (x, y, dir). Empty string -> (-1,-1,D_NONE)
    (the reference maps it to a null Loc, sgf.cpp:126-128)."""
    if s == "":
        return (-1, -1, D_NONE)
    if len(s) != 3:
        raise ValueError(f"Coffee SGF move must be 3 chars, got {s!r}")
    return (_parse_coord(s[0]), _parse_coord(s[1]), _parse_dir(s[2]))


# ---------------------------------------------------------------------------
# Generic SGF tree parsing (subset of the reference's Sgf/SgfNode)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SgfNode:
    props: dict[str, list[str]] = dataclasses.field(default_factory=dict)

    def get(self, key: str) -> str | None:
        v = self.props.get(key)
        return v[0] if v else None


@dataclasses.dataclass
class Sgf:
    """One game tree. `nodes` is the main line; `children` are alternate
    subtrees hanging off the position after the last main-line node (the
    reference keeps full trees too; its CompactSgf flattens the main line)."""

    nodes: list[SgfNode] = dataclasses.field(default_factory=list)
    children: list["Sgf"] = dataclasses.field(default_factory=list)

    # -- game-level accessors (CompactSgf equivalents) --

    @property
    def root(self) -> SgfNode:
        return self.nodes[0] if self.nodes else SgfNode()

    def board_size(self) -> tuple[int, int]:
        sz = self.root.get("SZ") or "5"
        if ":" in sz:
            x, y = sz.split(":")
            return int(x), int(y)
        return int(sz), int(sz)

    def win_len(self) -> int:
        return int(self.root.get("WLL") or 4)

    def placements(self) -> list[tuple[int, int, int]]:
        """[(x, y, player)] from AB/AW root placements."""
        out = []
        for key, pla in (("AB", 1), ("AW", 2)):
            for v in self.root.props.get(key, []):
                if len(v) != 2:
                    raise ValueError(f"bad placement {v!r}")
                out.append((_parse_coord(v[0]), _parse_coord(v[1]), pla))
        return out

    def moves(self) -> list[tuple[int, int, int, int]]:
        """Main-line [(x, y, dir, player)] with player 1=black 2=white."""
        out = []
        for node in self.nodes:
            for key, pla in (("B", 1), ("W", 2)):
                v = node.get(key)
                if v is not None:
                    x, y, d = sgf_to_move(v)
                    out.append((x, y, d, pla))
        return out

    def result(self) -> str | None:
        return self.root.get("RE")


class _Scanner:
    def __init__(self, text: str):
        self.text = text
        self.i = 0

    def skip_ws(self):
        while self.i < len(self.text) and self.text[self.i].isspace():
            self.i += 1

    def peek(self):
        self.skip_ws()
        return self.text[self.i] if self.i < len(self.text) else ""

    def next(self):
        c = self.peek()
        self.i += 1
        return c


_PROP_RE = re.compile(r"[A-Za-z]+")


def _parse_tree(sc: _Scanner) -> Sgf:
    if sc.next() != "(":
        raise ValueError("SGF: expected '('")
    sgf = Sgf()
    while True:
        c = sc.peek()
        if c == ";":
            sc.next()
            node = SgfNode()
            while True:
                sc.skip_ws()
                m = _PROP_RE.match(sc.text, sc.i)
                if not m:
                    break
                key = m.group(0)
                sc.i = m.end()
                vals = []
                while sc.peek() == "[":
                    sc.next()
                    buf = []
                    while True:
                        if sc.i >= len(sc.text):
                            raise ValueError("SGF: unterminated property value")
                        ch = sc.text[sc.i]
                        sc.i += 1
                        if ch == "\\" and sc.i < len(sc.text):
                            buf.append(sc.text[sc.i])
                            sc.i += 1
                        elif ch == "]":
                            break
                        else:
                            buf.append(ch)
                    vals.append("".join(buf))
                node.props.setdefault(key, []).extend(vals)
            sgf.nodes.append(node)
        elif c == "(":
            sgf.children.append(_parse_tree(sc))
        elif c == ")":
            sc.next()
            return sgf
        elif c == "":
            raise ValueError("SGF: unterminated tree")
        else:
            raise ValueError(f"SGF: unexpected char {c!r} at {sc.i}")


def parse_sgf(text: str) -> Sgf:
    """Parse one SGF game; the returned Sgf's `nodes` is the flattened main
    line (first-child descent), matching the reference's CompactSgf."""
    return _flatten_main_line(_parse_tree(_Scanner(text)))


def _flatten_main_line(tree: Sgf) -> Sgf:
    out = Sgf(nodes=list(tree.nodes), children=tree.children)
    node = tree
    while node.children:
        node = node.children[0]
        out.nodes.extend(node.nodes)
    return out


def parse_sgf_file(path: str) -> Sgf:
    with open(path, "r") as f:
        return parse_sgf(f.read())


# ---------------------------------------------------------------------------
# Writing (WriteSgf::writeSgf, sgf.cpp:1526-1700)
# ---------------------------------------------------------------------------


def _escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace("]", "\\]")


def write_sgf(
    x_size: int,
    y_size: int,
    win_len: int,
    moves: Iterable[tuple[int, int, int, int]],
    black_name: str = "black",
    white_name: str = "white",
    winner: int | None = None,  # 1 black, 2 white, 0 draw, None unfinished
    is_resignation: bool = False,
    placements: Iterable[tuple[int, int, int]] = (),
    comments: dict[int, str] | None = None,
    root_comment: str | None = None,
) -> str:
    parts = ["(;FF[4]GM[Coffee]"]
    if x_size == y_size:
        parts.append(f"SZ[{x_size}]")
    else:
        parts.append(f"SZ[{x_size}:{y_size}]")
    parts.append(f"WLL[{win_len}]")
    parts.append(f"PB[{_escape(black_name)}]")
    parts.append(f"PW[{_escape(white_name)}]")
    if winner is not None:
        if winner == 1:
            parts.append("RE[B+" + ("R" if is_resignation else "") + "]")
        elif winner == 2:
            parts.append("RE[W+" + ("R" if is_resignation else "") + "]")
        else:
            parts.append("RE[0]")  # draw: our documented extension
    ab = [p for p in placements if p[2] == 1]
    aw = [p for p in placements if p[2] == 2]
    if ab:
        parts.append("AB" + "".join(f"[{_coord_char(x)}{_coord_char(y)}]" for x, y, _ in ab))
    if aw:
        parts.append("AW" + "".join(f"[{_coord_char(x)}{_coord_char(y)}]" for x, y, _ in aw))
    if root_comment:
        parts.append(f"C[{_escape(root_comment)}]")
    for i, (x, y, d, pla) in enumerate(moves):
        tag = "B" if pla == 1 else "W"
        parts.append(f";{tag}[{move_to_sgf(x, y, d)}]")
        if comments and i in comments:
            parts.append(f"C[{_escape(comments[i])}]")
    parts.append(")")
    return "".join(parts)
