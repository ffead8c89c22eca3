"""Shared closed-loop knob controller core (the JAX package's
``tuning/controller.py``).

The reference's only adaptive element is the prefetch thread-count hill
climb (``S3BufferedPrefetchIterator``'s ThreadPredictor, :32-69). The
:class:`Controller` generalises it:

- **ladder**: the knob's ordered candidate values; its ends are the knob's
  clamps, and a decision moves at most one rung;
- **ring**: cost samples (lower is better) fill a fixed ring; each full ring
  records a total for the current rung and triggers one decision;
- **decision**: explore unmeasured neighbours first, then move to the
  measured neighbour with the lowest total; moving away drops the losing
  direction's stale total, so a drifting backend is probed again;
- **hysteresis**: a neighbour must beat the current rung by more than this
  fraction to win;
- **cooldown**: decisions no closer together than ``cooldown_s``.

The scan and commit tuners that bind it in the JAX package, and their
warm-start state, are not ported yet; :meth:`Controller._emit` is a no-op
until the metrics registry arrives.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

#: samples per decision ring (the reference predictor's 20-sample ring)
DEFAULT_RING_SIZE = 20


def geometric_ladder(lo: float, hi: float, factor: float = 2.0) -> List[int]:
    """Integer rungs ``lo, lo*factor, ... , hi`` (hi always included)."""
    if lo < 1 or hi < lo or factor <= 1:
        raise ValueError("need 1 <= lo <= hi and factor > 1")
    out: List[int] = []
    v = float(lo)
    while v < hi:
        out.append(int(round(v)))
        v *= factor
    out.append(int(hi))
    return sorted(dict.fromkeys(out))


class Controller:
    """Latency/cost-driven hill climb over an ordered value ladder.

    ``add_measurement_and_predict(cost)`` is the whole surface: feed one cost
    sample, get back the value to use next. With ``hysteresis=0`` and
    ``cooldown_s=0`` the decisions are the reference predictor's (ties
    resolve toward the lower rung)."""

    def __init__(
        self,
        ladder: Sequence[int],
        initial: Optional[int] = None,
        ring_size: int = DEFAULT_RING_SIZE,
        hysteresis: float = 0.0,
        cooldown_s: float = 0.0,
        knob: str = "",
        time_fn=time.monotonic,
    ):
        values = sorted(dict.fromkeys(int(v) for v in ladder))
        if not values:
            raise ValueError("ladder must not be empty")
        self.ladder = values
        if initial is None:
            initial = values[0]
        # clamp the seed onto the nearest rung
        self._i = min(
            range(len(values)), key=lambda j: (abs(values[j] - initial), j)
        )
        self.ring_size = max(1, int(ring_size))
        self.hysteresis = max(0.0, float(hysteresis))
        self.cooldown_s = max(0.0, float(cooldown_s))
        self.knob = knob
        self._time = time_fn
        self._ring: List[float] = []
        self._totals: Dict[int, float] = {}  # rung value -> ring total
        self._last_decision = -float("inf")
        #: completed decisions (full rings processed, holds included)
        self.decisions = 0
        #: rung changes (up + down moves)
        self.moves = 0
        #: rung an in-flight exploration left from (None = not exploring);
        #: with hysteresis on, the explored rung must beat it by the margin
        self._explored_from: Optional[int] = None

    @property
    def current(self) -> int:
        return self.ladder[self._i]

    def _emit(self, direction: str) -> None:
        """Decision metrics hook; a no-op until the metrics registry is
        ported."""

    def add_measurement_and_predict(self, cost: float) -> int:
        """Feed one cost sample (lower is better); returns the rung to use."""
        self._ring.append(cost)
        if len(self._ring) < self.ring_size:
            return self.current
        total = sum(self._ring)
        self._ring.clear()
        self._totals[self.current] = total
        now = self._time()
        if self.cooldown_s > 0 and now - self._last_decision < self.cooldown_s:
            # inside the cooldown window: the total is recorded, the rung holds
            return self.current
        self._last_decision = now
        self.decisions += 1
        down = self.ladder[max(0, self._i - 1)]
        up = self.ladder[min(len(self.ladder) - 1, self._i + 1)]
        # explore unmeasured neighbours first, then move to whichever
        # measured rung had the lowest total cost
        for candidate in (up, down):
            if candidate != self.current and candidate not in self._totals:
                self._explored_from = self.current
                self._i = self.ladder.index(candidate)
                self.moves += 1
                self._emit("up" if candidate == up else "down")
                return self.current
        current = self.current
        explored_from = self._explored_from
        self._explored_from = None
        best = min(
            {c: self._totals[c] for c in sorted({down, current, up})}.items(),
            key=lambda kv: kv[1],
        )[0]
        if best != current and self.hysteresis > 0.0:
            # the neighbour must be better by more than the margin
            if self._totals[best] >= self._totals[current] * (1.0 - self.hysteresis):
                best = current
        if (
            best == current
            and self.hysteresis > 0.0
            and explored_from is not None
            and explored_from != current
            and explored_from in self._totals
            and total >= self._totals[explored_from] * (1.0 - self.hysteresis)
        ):
            # reverse gate: a rung reached by exploration that is not better
            # than where it came from by the margin goes back
            best = explored_from
        if best != current:
            # forget the losing direction's stale total so a drifting
            # backend is probed again
            for candidate in (down, up):
                if candidate not in (best, current):
                    self._totals.pop(candidate, None)
            moved_up = best > current
            self._i = self.ladder.index(best)
            self.moves += 1
            self._emit("up" if moved_up else "down")
        else:
            self._emit("hold")
        return self.current
