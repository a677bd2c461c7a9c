"""Circuit breakers and health accounting for the scoring engine
(DESIGN.md §12). The port's copy of `repro.core.health` (stdlib only).

The engine's path ladder gives every fast path a fallback; the breaker
decides when to stop *trying* the fast path. Without one, a persistently
broken kernel (bad Mosaic lowering after a toolchain bump, a shape class
that reliably exhausts VMEM) pays a failed attempt — compile time, an
exception, a retried batch — on every single call before degrading. The
breaker converts that into: fail `failure_threshold` consecutive times,
then serve straight from the fallback for a cool-down, then let ONE probe
through (half-open); success closes the breaker, failure re-opens it with
exponentially longer cool-downs (capped).

Breakers are keyed per (path, shape-class) by the engine: a kernel that
dies on 128-node overflow tiles keeps serving 64-node traffic normally.

The clock is injectable so tests drive open -> half-open -> closed
transitions deterministically (no sleeps), same pattern as
`serve.batching.MicroBatcher`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


@dataclass
class CircuitBreaker:
    """Consecutive-failure breaker with exponential-backoff cool-downs.

    States: `closed` (normal; counting consecutive failures), `open`
    (rejecting — serve the fallback; entered after `failure_threshold`
    consecutive failures), `half_open` (cool-down elapsed; the next attempt
    is a probe — success closes, failure re-opens with the cool-down
    doubled, up to `max_cooldown_s`).
    """
    failure_threshold: int = 3
    cooldown_s: float = 30.0
    backoff: float = 2.0
    max_cooldown_s: float = 600.0
    clock: Callable[[], float] = time.monotonic

    state: str = field(default=CLOSED, init=False)
    consecutive_failures: int = field(default=0, init=False)
    failures: int = field(default=0, init=False)      # lifetime totals
    successes: int = field(default=0, init=False)
    rejections: int = field(default=0, init=False)    # calls turned away
    open_count: int = field(default=0, init=False)    # times opened (drives
                                                      # the backoff exponent)
    opened_at: float | None = field(default=None, init=False)

    def current_cooldown(self) -> float:
        exp = max(self.open_count - 1, 0)
        return min(self.cooldown_s * self.backoff ** exp, self.max_cooldown_s)

    def allow(self) -> bool:
        """May the protected path be attempted right now? Open breakers
        flip to half-open once the cool-down has elapsed (the probe)."""
        if self.state == OPEN:
            if (self.clock() - self.opened_at) >= self.current_cooldown():
                self.state = HALF_OPEN
            else:
                self.rejections += 1
                return False
        return True

    def record_success(self) -> None:
        self.successes += 1
        self.consecutive_failures = 0
        if self.state != CLOSED:
            self.state = CLOSED
            self.open_count = 0        # healthy again: backoff resets
            self.opened_at = None

    def record_failure(self) -> None:
        self.failures += 1
        self.consecutive_failures += 1
        if (self.state == HALF_OPEN
                or self.consecutive_failures >= self.failure_threshold):
            self.state = OPEN
            self.open_count += 1
            self.opened_at = self.clock()

    def snapshot(self) -> dict:
        """Serializable state for `engine.health()` / dashboards."""
        snap = {"state": self.state,
                "consecutive_failures": self.consecutive_failures,
                "failures": self.failures, "successes": self.successes,
                "rejections": self.rejections,
                "open_count": self.open_count}
        if self.state == OPEN:
            snap["cooldown_remaining_s"] = round(max(
                0.0, self.current_cooldown()
                - (self.clock() - self.opened_at)), 6)
        return snap
