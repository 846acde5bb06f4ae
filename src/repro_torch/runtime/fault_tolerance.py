"""The generic restart loop (a copy of ``repro.runtime.fault_tolerance``'s
:func:`run_with_restarts`).

It executes a step function, detects a failure, hands the failed step to a
restore function and continues from the step that returns.  The serving
stack runs its retry policy through it (``serve.server``), so serving and
a future training loop share one restart skeleton.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

__all__ = ["run_with_restarts"]


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
