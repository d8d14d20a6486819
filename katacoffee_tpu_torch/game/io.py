"""Human-readable move and board strings: the port's copy of
`katacoffee_tpu/game/io.py` (plain Python), the GameIO/Location string layer
of the reference (`cpp/game/board.cpp:505-700`):

  * spot string: column letter (A-H,J-Z — 'I' skipped) + row number counted
    from the bottom (`Location::toString`, board.cpp:674-691);
  * direction strings: north/west/northwest/northeast (+ short aliases
    n/w/nw/ne on parse, board.cpp:615-637);
  * a full move ("loc") is "<spot> <direction>", e.g. "C3 northwest"
    (GameIO::locToString, board.cpp:594-596);
  * board parse/print with x/X=black, o/O=white, .=empty
    (Board::parseBoard / toStringSimple, board.cpp:877-947).
"""

from __future__ import annotations

import numpy as np

from katacoffee_tpu_torch.game.board import (
    D_NONE,
    D_NORTH,
    D_NORTHEAST,
    D_NORTHWEST,
    D_WEST,
    GameConfig,
)

_X_CHARS = "ABCDEFGHJKLMNOPQRSTUVWXYZ"  # no 'I' (board.cpp:678)

_DIR_NAMES = {
    D_NORTH: "north",
    D_WEST: "west",
    D_NORTHWEST: "northwest",
    D_NORTHEAST: "northeast",
    D_NONE: "none",
}
_DIR_PARSE = {
    "north": D_NORTH,
    "n": D_NORTH,
    "west": D_WEST,
    "w": D_WEST,
    "northwest": D_NORTHWEST,
    "nw": D_NORTHWEST,
    "northeast": D_NORTHEAST,
    "ne": D_NORTHEAST,
    "none": D_NONE,
    "no": D_NONE,
    "null": D_NONE,
    "nil": D_NONE,
    "0": D_NONE,
}
# fancy single-char direction glyphs (board.cpp:509-545)
DIR_GLYPHS = {D_NORTH: "|", D_WEST: "-", D_NORTHWEST: "\\", D_NORTHEAST: "/", D_NONE: " "}


def spot_to_string(x: int, y: int, cfg: GameConfig) -> str:
    if x < 0 or y < 0:
        return "null"
    if x <= 24:
        col = _X_CHARS[x]
    else:
        col = _X_CHARS[x // 25 - 1] + _X_CHARS[x % 25]
    return f"{col}{cfg.y_size - y}"


def parse_spot(s: str, cfg: GameConfig) -> tuple[int, int]:
    s = s.strip().upper()
    if not s or not s[0].isalpha():
        raise ValueError(f"bad spot: {s!r}")
    i = 0
    while i < len(s) and s[i].isalpha():
        i += 1
    letters, digits = s[:i], s[i:]
    if not digits.isdigit():
        raise ValueError(f"bad spot: {s!r}")
    if len(letters) == 1:
        x = _X_CHARS.index(letters)
    elif len(letters) == 2:
        x = (_X_CHARS.index(letters[0]) + 1) * 25 + _X_CHARS.index(letters[1])
    else:
        raise ValueError(f"bad spot: {s!r}")
    y = cfg.y_size - int(digits)
    if not (0 <= x < cfg.x_size and 0 <= y < cfg.y_size):
        raise ValueError(f"spot off board: {s!r}")
    return x, y


def direction_to_string(d: int) -> str:
    return _DIR_NAMES[d]


def parse_direction(s: str) -> int:
    d = _DIR_PARSE.get(s.strip().lower())
    if d is None:
        raise ValueError(f"bad direction: {s!r}")
    return d


def loc_to_string(x: int, y: int, d: int, cfg: GameConfig) -> str:
    return f"{spot_to_string(x, y, cfg)} {direction_to_string(d)}"


def parse_loc(s: str, cfg: GameConfig) -> tuple[int, int, int]:
    """'C3 northwest' -> (x, y, dir). Also accepts 'C3NW' / 'C3 nw'."""
    s = s.strip()
    if " " in s:
        spot_s, dir_s = s.split(None, 1)
    else:
        # split at first trailing alpha run after the digits
        i = 0
        while i < len(s) and s[i].isalpha():
            i += 1
        while i < len(s) and s[i].isdigit():
            i += 1
        spot_s, dir_s = s[:i], s[i:]
        if not dir_s:
            raise ValueError(f"move needs a direction: {s!r}")
    x, y = parse_spot(spot_s, cfg)
    return x, y, parse_direction(dir_s)


_DIR_SHORT = {D_NORTH: "N", D_WEST: "W", D_NORTHWEST: "NW", D_NORTHEAST: "NE"}


def loc_to_compact(x: int, y: int, d: int, cfg: GameConfig) -> str:
    """Space-free move form for machine protocols, e.g. 'C3NW' (parse_loc
    accepts it back). Analyze-line fields cannot contain spaces."""
    return spot_to_string(x, y, cfg) + _DIR_SHORT[d]


def action_to_compact(action: int, cfg: GameConfig) -> str:
    area = cfg.area
    d, spot = action // area, action % area
    return loc_to_compact(spot % cfg.x_size, spot // cfg.x_size, d, cfg)


def action_to_string(action: int, cfg: GameConfig) -> str:
    """Flat dir-major policy action -> 'C3 northwest'."""
    area = cfg.area
    d, spot = action // area, action % area
    return loc_to_string(spot % cfg.x_size, spot // cfg.x_size, d, cfg)


def parse_action(s: str, cfg: GameConfig) -> int:
    x, y, d = parse_loc(s, cfg)
    return d * cfg.area + y * cfg.x_size + x


def board_to_string(board: np.ndarray, cfg: GameConfig, coords: bool = True) -> str:
    """ASCII board: X black, O white, . empty; coordinates like printBoard."""
    board = np.asarray(board)
    lines = []
    if coords:
        lines.append("   " + " ".join(_X_CHARS[x] for x in range(cfg.x_size)))
    for y in range(cfg.y_size):
        row = " ".join(".XO"[int(board[y, x])] for x in range(cfg.x_size))
        if coords:
            lines.append(f"{cfg.y_size - y:2d} {row}")
        else:
            lines.append(row)
    return "\n".join(lines)


def parse_board(text: str, cfg: GameConfig) -> np.ndarray:
    """Parse an ASCII board (Board::parseBoard character set: . space * , `
    empty; x/X black; o/O white). Tolerates coordinate labels."""
    rows = [ln for ln in (l.strip() for l in text.splitlines()) if ln]
    if len(rows) == cfg.y_size + 1 and rows[0].upper().startswith("A"):
        rows = rows[1:]
    if len(rows) != cfg.y_size:
        raise ValueError(f"expected {cfg.y_size} rows, got {len(rows)}")
    out = np.zeros((cfg.y_size, cfg.x_size), np.int8)
    for y, ln in enumerate(rows):
        # strip leading row number
        i = 0
        while i < len(ln) and ln[i].isdigit():
            i += 1
        ln = ln[i:].strip()
        cells = ln.split() if " " in ln else list(ln)
        if len(cells) != cfg.x_size:
            raise ValueError(f"row {y}: expected {cfg.x_size} cells, got {len(cells)}")
        for x, c in enumerate(cells):
            if c in ".* ,`":
                continue
            elif c in "xX":
                out[y, x] = 1
            elif c in "oO":
                out[y, x] = 2
            else:
                raise ValueError(f"bad board char {c!r}")
    return out
