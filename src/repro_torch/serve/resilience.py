"""Resilience primitives for the serving stack: retry policy + breaker
(copied from ``repro.serve.resilience``, same metric names).

:class:`RetryPolicy` is pure data — how many times to re-attempt a
failed batch and how long to back off between attempts.  The server
executes it through
:func:`repro_torch.runtime.fault_tolerance.run_with_restarts`,
so serving and training share one restart skeleton.

:class:`CircuitBreaker` is the classic three-state machine, one per
bucket: **closed** (serving normally; consecutive failures counted) →
**open** after ``failure_threshold`` consecutive failures (primary
attempts skipped — no retry storm against a plan that cannot compile on
this host) → **half_open** after ``reset_timeout_s`` (exactly one probe
attempt allowed; success closes the breaker, failure re-opens it).
Transitions are counted on the port's ``obs`` registry
(``serve.breaker.transitions``, labels: name/from/to/scope) so
``Server.stats()`` and the span log can show *when* a bucket degraded.

Thread-safety: all state sits behind one lock; the clock is injectable
for deterministic tests.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Optional

from .. import obs

__all__ = ["RetryPolicy", "CircuitBreaker"]

_TRANSITIONS = obs.registry().counter(
    "serve.breaker.transitions",
    "circuit-breaker state transitions (labels: name, from, to, scope)")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with exponential backoff.

    ``max_retries`` extra attempts follow a failed first attempt;
    attempt ``k``'s backoff is ``backoff_s * multiplier**(k-1)``, capped
    at ``max_backoff_s``.  ``RetryPolicy(max_retries=0)`` disables
    retries without disabling the policy plumbing.
    """
    max_retries: int = 2
    backoff_s: float = 0.01
    multiplier: float = 2.0
    max_backoff_s: float = 1.0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_s < 0 or self.max_backoff_s < 0:
            raise ValueError("backoff seconds must be >= 0")
        if self.multiplier < 1.0:
            raise ValueError("multiplier must be >= 1")

    def delay_s(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based)."""
        if attempt < 1:
            raise ValueError("attempt is 1-based")
        return min(self.backoff_s * self.multiplier ** (attempt - 1),
                   self.max_backoff_s)


class CircuitBreaker:
    """closed → open after N consecutive failures → half-open probe."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, failure_threshold: int = 3,
                 reset_timeout_s: float = 30.0, *, name: str = "",
                 scope: str = "",
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if reset_timeout_s < 0:
            raise ValueError("reset_timeout_s must be >= 0")
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.name = name
        self.scope = scope
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0          # consecutive, while closed
        self._opened_at: Optional[float] = None
        self._probing = False       # half-open probe outstanding
        self._opens = 0
        self._transitions = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May the next attempt proceed?  Transitions open → half_open
        once the cooldown elapses and hands out exactly one probe."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if self._clock() - self._opened_at >= self.reset_timeout_s:
                    self._transition(self.HALF_OPEN)
                    self._probing = True
                    return True
                return False
            # half-open: one probe at a time
            if self._probing:
                return False
            self._probing = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probing = False
            if self._state != self.CLOSED:
                self._transition(self.CLOSED)

    def release(self) -> None:
        """End an attempt whose outcome says nothing of the backend's
        health (a kernel that did not build or launch, which the server
        raises): the state stays, and a half-open probe is handed out
        again."""
        with self._lock:
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            self._probing = False
            if self._state == self.HALF_OPEN:
                self._open()
            elif self._state == self.CLOSED:
                self._failures += 1
                if self._failures >= self.failure_threshold:
                    self._open()

    def _open(self) -> None:
        self._opened_at = self._clock()
        self._opens += 1
        self._transition(self.OPEN)

    def _transition(self, to: str) -> None:
        _TRANSITIONS.inc(**{"name": self.name, "from": self._state,
                            "to": to, "scope": self.scope})
        self._state = to
        self._transitions += 1

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {"state": self._state, "failures": self._failures,
                    "opens": self._opens,
                    "transitions": self._transitions}
