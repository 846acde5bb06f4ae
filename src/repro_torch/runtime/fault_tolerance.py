"""Fault tolerance and elasticity: heartbeats, stragglers, elastic meshes
and the restart loop (a copy of ``repro.runtime.fault_tolerance``, pure
Python: on the same inputs it reaches the same decisions).

The policy layer is hardware-agnostic: ``HeartbeatMonitor`` reports dead
hosts, ``StragglerDetector`` flags slow steps (``launch.train.train_loop``
records each step's time in one), ``ElasticScaler`` chooses a mesh for the
devices that remain.  :func:`run_with_restarts` executes a step function,
detects a failure, hands the failed step to a restore function and
continues from the step that returns.  The serving stack runs its retry
policy through it (``serve.server``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["ElasticPlan", "ElasticScaler", "HeartbeatMonitor",
           "StragglerDetector", "run_with_restarts"]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """What to do after a capacity change."""
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    restore_step: Optional[int]
    dropped_hosts: Tuple[int, ...] = ()

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.mesh_shape:
            n *= s
        return n


class HeartbeatMonitor:
    """Tracks per-host heartbeats; reports dead hosts past a timeout."""

    def __init__(self, hosts: Sequence[int], timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self._clock = clock
        now = clock()
        self._last: Dict[int, float] = {h: now for h in hosts}

    def beat(self, host: int) -> None:
        self._last[host] = self._clock()

    def dead_hosts(self) -> List[int]:
        now = self._clock()
        return sorted(h for h, t in self._last.items()
                      if now - t > self.timeout_s)

    def remove(self, host: int) -> None:
        self._last.pop(host, None)


class StragglerDetector:
    """Flags steps (or hosts) whose duration is an outlier vs the median.

    Mitigation at scale: re-balance the data shard of a persistent straggler
    or evict it (turn it into a heartbeat failure).  The detector implements
    the policy; the training loop applies it.
    """

    def __init__(self, window: int = 50, threshold: float = 2.0,
                 patience: int = 3):
        self.window = window
        self.threshold = threshold
        self.patience = patience
        self._durations: List[float] = []
        self._strikes: Dict[int, int] = {}

    #: minimum prior samples before a measurement can be judged — small
    #: enough that an obvious straggler in the first handful of steps is
    #: flagged (a 5-sample warm-up used to mask it), large enough that a
    #: 1-sample "median" doesn't flag normal jitter
    MIN_HISTORY = 3

    def record(self, duration_s: float, host: Optional[int] = None) -> bool:
        """Returns True if this measurement is a straggler event."""
        hist = self._durations[-self.window:]
        self._durations.append(duration_s)
        if len(hist) < self.MIN_HISTORY:
            return False
        med = sorted(hist)[len(hist) // 2]
        is_straggler = duration_s > self.threshold * med
        if host is not None:
            if is_straggler:
                self._strikes[host] = self._strikes.get(host, 0) + 1
            else:
                self._strikes[host] = 0
        return is_straggler

    def should_evict(self, host: int) -> bool:
        return self._strikes.get(host, 0) >= self.patience

    @property
    def median_step_s(self) -> Optional[float]:
        if not self._durations:
            return None
        h = sorted(self._durations[-self.window:])
        return h[len(h) // 2]


class ElasticScaler:
    """Chooses a mesh for the devices that remain.

    Keeps the model axis fixed (TP degree is baked into layouts/kernels) and
    shrinks/grows the data axis; pods with fewer than ``model_axis`` chips
    are dropped entirely.
    """

    def __init__(self, model_axis: int = 16, pod_chips: int = 256):
        self.model_axis = model_axis
        self.pod_chips = pod_chips

    def plan(self, devices_up: int, restore_step: Optional[int],
             dropped_hosts: Sequence[int] = ()) -> ElasticPlan:
        pods = devices_up // self.pod_chips
        if pods >= 2:
            data = self.pod_chips // self.model_axis
            return ElasticPlan((pods, data, self.model_axis),
                               ("pod", "data", "model"), restore_step,
                               tuple(dropped_hosts))
        data = max(1, devices_up // self.model_axis)
        return ElasticPlan((data, self.model_axis), ("data", "model"),
                           restore_step, tuple(dropped_hosts))


def run_with_restarts(step_fn: Callable[[int], None],
                      restore_fn: Callable[[int], int],
                      n_steps: int, *, start_step: int = 0,
                      max_restarts: int = 3,
                      failure_types: Tuple[type, ...] = (RuntimeError,)
                      ) -> Dict[str, int]:
    """Run ``step_fn(step)`` for ``n_steps``; on failure, call
    ``restore_fn(failed_step) -> resume_step`` and continue.

    Returns counters {"completed": ..., "restarts": ...}; re-raises the
    failure once ``max_restarts`` restarts are spent.
    """
    restarts = 0
    step = start_step
    while step < n_steps:
        try:
            step_fn(step)
            step += 1
        except failure_types:
            restarts += 1
            if restarts > max_restarts:
                raise
            step = restore_fn(step)
    return {"completed": step - start_step, "restarts": restarts}
