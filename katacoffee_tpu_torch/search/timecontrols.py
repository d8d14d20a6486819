"""Time controls: the port's copy of `katacoffee_tpu/search/timecontrols.py`
(plain Python, no JAX in it, copied so that the port imports nothing of the
JAX package): Fischer and byo-yomi budgeting, the role of the reference's
`cpp/search/timecontrols.{h,cpp}` (TimeControls, timecontrols.h:8) and the
lag/buffer shaping of `searchtimehelpers.cpp`.

The search is visit-bounded: the time budget for a move is computed as the
reference does, then turned into a visit cap with the engine's measured
visits per second (`visits_for_time`), between chunks of the streamed
search.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TimeControls:
    """State of one player's clock. Mirrors TimeControls fields
    (timecontrols.h:10-34): system NONE / ABSOLUTE / FISCHER / BYO_YOMI."""

    system: str = "none"  # none | absolute | fischer | byo_yomi
    main_time_left: float = 0.0
    increment: float = 0.0  # fischer
    period_time: float = 0.0  # byo-yomi
    periods_left: int = 0
    in_overtime: bool = False
    # Canadian overtime: periods_left counts STONES sharing one block of
    # time, so GTP time_left reports (time for stones) rather than
    # (per-period time, periods)
    per_stone: bool = False

    @staticmethod
    def absolute(main_time: float) -> "TimeControls":
        return TimeControls(system="absolute", main_time_left=main_time)

    @staticmethod
    def fischer(main_time: float, increment: float) -> "TimeControls":
        return TimeControls(system="fischer", main_time_left=main_time, increment=increment)

    @staticmethod
    def byo_yomi(
        main_time: float, period_time: float, periods: int, per_stone: bool = False
    ) -> "TimeControls":
        return TimeControls(
            system="byo_yomi",
            main_time_left=main_time,
            period_time=period_time,
            periods_left=periods,
            per_stone=per_stone,
        )

    def time_for_move(self, moves_left_estimate: int = 12, lag_buffer: float = 0.2) -> float:
        """Seconds to spend on this move (TimeControls::getLimits semantics,
        simplified: spread main time over an estimated remaining-move count,
        add the per-move increment/period, keep a lag buffer)."""
        if self.system == "none":
            return float("inf")
        main = max(self.main_time_left - lag_buffer, 0.0)
        if self.system == "absolute":
            return main / max(moves_left_estimate, 1)
        if self.system == "fischer":
            return main / max(moves_left_estimate, 1) + max(self.increment - lag_buffer, 0.0)
        if self.system == "byo_yomi":
            if self.main_time_left > lag_buffer:
                # spend down main time, keeping periods in reserve
                return main / max(moves_left_estimate, 1)
            if self.periods_left >= 1:
                # in overtime: use one period per move, minus safety margin
                return max(self.period_time - lag_buffer, 0.01)
            return 0.01
        raise ValueError(f"unknown time system {self.system}")

    def update_after_move(self, time_used: float):
        """Apply clock accounting after spending `time_used` seconds."""
        if self.system == "none":
            return
        if self.system == "fischer":
            self.main_time_left = self.main_time_left - time_used + self.increment
        elif self.system == "absolute":
            self.main_time_left -= time_used
        elif self.system == "byo_yomi":
            if self.main_time_left > 0:
                self.main_time_left -= time_used
                if self.main_time_left < 0:
                    self.in_overtime = True
                    self.main_time_left = 0.0
            else:
                self.in_overtime = True
                # a move within the period resets it; exceeding consumes periods
                over = time_used - self.period_time
                while over > 0 and self.periods_left > 1:
                    self.periods_left -= 1
                    over -= self.period_time


def visits_for_time(
    time_budget: float,
    visits_per_second: float,
    max_visits: int,
    min_visits: int = 2,
) -> int:
    """Convert a seconds budget into a visit cap given measured throughput."""
    if time_budget == float("inf"):
        return max_visits
    v = int(time_budget * visits_per_second)
    return max(min_visits, min(v, max_visits))


# ---------------------------------------------------------------------------
# Time-management shaping (Search::recomputeSearchTimeLimit,
# cpp/search/searchtimehelpers.cpp; params searchparams.h:127-148)
# ---------------------------------------------------------------------------


def midgame_weight(sp, turn_number: int, board_area: int) -> float:
    """Midgame emphasis in [0,1]: linear ramp to midgameTurnPeakTime (scaled
    by boardArea/361), then exponential decay with endgameTurnTimeDecay
    (searchtimehelpers.cpp:47-66)."""
    import math

    scale = board_area / 361.0
    t = max(float(turn_number), 0.0)
    peak = sp.midgameTurnPeakTime * scale
    if t < peak:
        w = t / peak if peak > 0 else 1.0
    else:
        w = math.exp(-(t - peak) / (sp.endgameTurnTimeDecay * scale))
    return min(max(w, 0.0), 1.0)


def obviousness_weight(sp, policy_entropy: float, policy_surprise: float) -> float:
    """How "obvious" this move is, in [0,1]: confident raw policy (low
    entropy) AND a search that agreed with it (low surprise)
    (searchtimehelpers.cpp:68-81)."""
    import math

    by_entropy = math.exp(-policy_entropy / sp.obviousMovesPolicyEntropyTolerance)
    by_surprise = math.exp(-policy_surprise / sp.obviousMovesPolicySurpriseTolerance)
    return min(by_entropy, by_surprise)


def shaped_time_budget(
    sp,
    base_budget: float,
    turn_number: int,
    board_area: int,
    policy_entropy: float | None = None,
    policy_surprise: float | None = None,
) -> float:
    """The deterministic part of recomputeSearchTimeLimit
    (searchtimehelpers.cpp:37-81): overallocation, midgame emphasis, and —
    when this move's entropy/surprise are available (from a probe search in
    our visit-bounded adaptation) — the obvious-move discount."""
    rec = base_budget * sp.overallocateTimeFactor
    if sp.midgameTimeFactor != 1.0:
        w = midgame_weight(sp, turn_number, board_area)
        rec *= 1.0 + w * (sp.midgameTimeFactor - 1.0)
    if (
        sp.obviousMovesTimeFactor < 1.0
        and policy_entropy is not None
        and policy_surprise is not None
    ):
        w = obviousness_weight(sp, policy_entropy, policy_surprise)
        rec *= 1.0 + w * (sp.obviousMovesTimeFactor - 1.0)
    return rec


def interpolate_early(halflife: float, early: float, late: float, turn_number: float) -> float:
    """Search::interpolateEarly (searchhelpers.cpp): exponential decay from
    `early` to `late` with the given halflife in turns."""
    frac = 0.5 ** (max(turn_number, 0.0) / max(halflife, 1e-9))
    return late + (early - late) * frac


def num_visits_needed_to_be_non_futile(
    sp, max_visits_move_visits: float, chosen_move_temperature: float
) -> float:
    """Search::numVisitsNeededToBeNonFutile (searchtimehelpers.cpp:10-20):
    an alternative move must be able to reach this many visits to still
    matter, given futileVisitsThreshold and the move-choice temperature."""
    required = sp.futileVisitsThreshold * max_visits_move_visits
    if chosen_move_temperature < 1e-3:
        return required
    required_due_to_temp = max_visits_move_visits * (0.01**chosen_move_temperature)
    return min(required, required_due_to_temp)


def is_search_futile(
    sp,
    visit_counts,
    play_selection_values,
    visits_left_upper_bound: float,
    chosen_move_temperature: float,
) -> bool:
    """The futile-visits early stop (searchtimehelpers.cpp:100-140): true
    when the most-visited move is also the selected move and NO alternative
    can reach non-futile visits within the remaining budget. In the
    reference the budget is time-derived (computeUpperBoundVisitsLeftDueToTime);
    in the lockstep engine it is the remaining visit budget directly."""
    if sp.futileVisitsThreshold <= 0 or len(visit_counts) == 0:
        return False
    if len(visit_counts) != len(play_selection_values):
        return False
    best_idx = max(range(len(play_selection_values)), key=lambda i: play_selection_values[i])
    max_idx = max(range(len(visit_counts)), key=lambda i: visit_counts[i])
    if best_idx != max_idx:
        return False
    required = num_visits_needed_to_be_non_futile(
        sp, visit_counts[max_idx], chosen_move_temperature
    )
    for i, v in enumerate(visit_counts):
        if i == best_idx:
            continue
        if v + visits_left_upper_bound >= required:
            return False
    return True
