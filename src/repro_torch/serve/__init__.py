"""Solver-as-a-service on the card: batched, cached, concurrent plan serving.

The port of ``repro.serve``.  The layers, bottom-up:

* :class:`BatchedPlan` — a plan's lane-batched program (operator leaves
  shared, input leaves batched on a leading lane axis): on the ``cuda``
  backend one CUDA-graph replay over B1, B2 and B4 in their lane forms
  answers a whole batch.
* :class:`PlanRouter` — requests carry ``(workload, params, dtype,
  density bucket, backend)``; the router canonicalizes that to a
  :class:`BucketKey` and keeps a bounded LRU of resident ``BatchedPlan``\\ s,
  each with its shared operator on the device.
* :class:`Server` — an async request queue whose worker loop coalesces
  same-bucket requests into one batch (``max_batch_size`` /
  ``max_wait_us`` knobs) and resolves per-request futures with outputs
  and residuals; ``Server.stats()`` surfaces per-bucket counters.

On top of that sits the failure-handling layer: per-request deadlines,
bounded-queue admission control (:class:`Overloaded`), retry + backend
fallback behind per-bucket circuit breakers (:class:`CircuitBreaker`),
and worker supervision with ``Server.health()``.

Quickstart::

    from repro_torch.api import ServeConfig
    from repro_torch.serve import Server, request

    with Server(ServeConfig(max_batch_size=16)) as srv:   # on the card
        futs = [srv.submit(request("cg", n=4096, iters=64, seed=s,
                                   backend="cuda"))
                for s in range(32)]
        results = [f.result() for f in futs]
    print(results[0].residual, results[0].batch_size)
"""
from ..api.config import ServeConfig
from .batched import BatchedPlan
from .errors import (CircuitOpen, DeadlineExceeded, Overloaded, ServeError,
                     ServerClosed, WorkerCrashed)
from .resilience import CircuitBreaker, RetryPolicy
from .router import (BucketKey, PlanRouter, SolveRequest, density_bucket,
                     request)
from .server import Server, SolveResult

__all__ = ["BatchedPlan", "BucketKey", "CircuitBreaker", "CircuitOpen",
           "DeadlineExceeded", "Overloaded", "PlanRouter", "RetryPolicy",
           "ServeConfig", "ServeError", "Server", "ServerClosed",
           "SolveRequest",
           "SolveResult", "WorkerCrashed", "density_bucket", "request"]
