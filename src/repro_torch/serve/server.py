"""`Server`: an async request queue that coalesces solves into batches.

A copy of ``repro.serve.server`` on the port's router and lane-batched
plans.  Callers :meth:`~Server.submit`
:class:`~repro_torch.serve.router.SolveRequest`\\ s and get back
``concurrent.futures.Future``\\ s; one worker thread drains the queue,
grouping same-bucket requests into a single
:class:`~repro_torch.serve.batched.BatchedPlan` dispatch (one CUDA-graph
replay on the ``cuda`` backend).  Two knobs trade
latency for throughput:

* ``max_batch_size`` — a batch closes as soon as this many same-bucket
  requests are queued;
* ``max_wait_us`` — a batch also closes once its oldest request has waited
  this long, so a trickle of traffic is not stalled fishing for batchmates.

``policy`` picks which bucket the worker drains next: ``oldest`` (default,
longest-waiting head request) or ``round_robin`` (least-recently-served
non-empty bucket — no bucket starves under sustained hot-bucket load).

All device work happens on the one worker thread, on that thread's own
CUDA stream (routing, uploads, compiles, captures and replays never race
each other), and the stream is synchronized before a batch's futures
resolve, so a result's tensors are complete when a client reads them;
``submit`` only canonicalizes the bucket key — invalid requests raise in
the caller, never poison the queue.  Execution errors propagate through
each affected request's future.  There is no precision context: a
request's dtype picks its bucket, and fp32 and fp64 buckets run side by
side.

**Failure handling** (see ``docs/serving.md`` / ``docs/robustness.md``):

* *Deadlines* — ``submit(req, deadline_s=...)``: the request expires
  in-queue with a typed :class:`~repro_torch.serve.errors.DeadlineExceeded`
  once its deadline passes, and the worker closes a batch early rather
  than coalesce past a member's deadline.
* *Admission control* — ``max_queue`` bounds the queue; the ``overload``
  policy decides what happens at the bound: ``block`` (submit waits,
  still honouring its deadline), ``reject`` (submit raises a typed
  :class:`~repro_torch.serve.errors.Overloaded`), or ``shed_oldest`` (the
  oldest queued request's future fails with ``Overloaded`` to admit the
  new one).
* *Graceful degradation* — a failed batch attempt is retried per
  ``retry`` (a :class:`~repro_torch.serve.resilience.RetryPolicy`, executed
  through the shared ``run_with_restarts`` skeleton), and a bucket whose
  primary backend keeps failing is served by the ``fallback`` backend
  (default ``reference`` — the interpreter, on the same device, so
  degraded answers are exact, just slower) behind a per-bucket
  :class:`~repro_torch.serve.resilience.CircuitBreaker`.  A kernel that
  does not build or launch (``kernels.build.KernelError``) is none of
  these: it is neither retried nor fallen back from, the breaker does not
  count it, and it fails the batch's futures.
* *Worker supervision* — a worker-thread crash fails exactly the
  in-flight batch's futures with a typed
  :class:`~repro_torch.serve.errors.WorkerCrashed` and restarts the worker (up
  to ``max_worker_restarts``; after that the server is *down* and
  queued/new requests fail typed).  :meth:`Server.health` summarizes
  {ok, degraded, down} plus breaker states.

``stats()`` is the observability surface: per-bucket request/batch
counters, a batch-size histogram, queue-wait / end-to-end latency
quantiles, plan-cache hits/misses, the batched plan's
dispatch/trace counters, current queue depth, and every robustness
counter (rejected / shed / deadline_missed / retries / fallbacks /
breaker transitions / worker restarts).  The counters live on the
port's ``obs`` registry (under this server's unique scope label) and the
whole snapshot is taken while holding the server's condition variable,
so it is consistent: at any instant
``requests == queued + in_flight + errors + sum(size * count)`` over the
batch-size histogram (shed / expired / crashed / client-cancelled
requests count under ``errors``; rejected requests were never admitted
and are tallied separately).

A client may ``cancel()`` its future while the request is still queued;
the worker marks every future *running* when it pops the batch
(``set_running_or_notify_cancel``), so a won cancel simply drops the
request (counted under ``errors``) and a lost one can no longer race the
result — no settle site ever raises ``InvalidStateError`` into the
worker or an unrelated submitter.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Any, Dict, List, Optional

import torch

from .. import obs
from ..api.config import ServeConfig
from ..kernels.build import KernelError
from ..runtime.fault_tolerance import run_with_restarts
from ..testing import faults
from .errors import (CircuitOpen, DeadlineExceeded, Overloaded, ServerClosed,
                     WorkerCrashed)
from .resilience import CircuitBreaker, RetryPolicy
from .router import BucketKey, PlanRouter, SolveRequest

__all__ = ["Server", "SolveResult"]

_REQUESTS = obs.registry().counter(
    "serve.requests", "requests accepted into the queue, per bucket and "
    "server (scope label)")
_BATCHES = obs.registry().counter(
    "serve.batches", "coalesced batches served, per bucket")
_BATCH_SIZE = obs.registry().counter(
    "serve.batch_size", "batches by exact coalesced size (labels: bucket, "
    "size) — a counter, not a histogram, so sizes stay exact")
_ERRORS = obs.registry().counter(
    "serve.errors", "requests failed through their futures, per bucket")
_QUEUE_WAIT_S = obs.registry().histogram(
    "serve.queue_wait_s", "submit -> batch-close wait, per request",
    unit="s")
_BATCH_BUILD_S = obs.registry().histogram(
    "serve.batch_build_s", "plan routing + per-request feed build, per "
    "batch", unit="s")
_DISPATCH_S = obs.registry().histogram(
    "serve.dispatch_s", "batched dispatch wall-clock, per batch (the "
    "worker's stream is synchronized inside it, so this covers device "
    "time)", unit="s")
_E2E_S = obs.registry().histogram(
    "serve.e2e_latency_s", "submit -> result end-to-end latency, per "
    "request", unit="s")
_REJECTED = obs.registry().counter(
    "serve.rejected", "requests rejected at submit by the overload policy "
    "(never admitted — not part of serve.requests), per bucket")
_SHED = obs.registry().counter(
    "serve.shed", "admitted requests shed from the queue head by "
    "overload='shed_oldest', per bucket")
_EXPIRED = obs.registry().counter(
    "serve.deadline_missed", "requests expired by their deadline (in-queue "
    "or while blocked on admission), per bucket")
_RETRIES = obs.registry().counter(
    "serve.retries", "batch attempt retries (RetryPolicy), per bucket")
_FALLBACKS = obs.registry().counter(
    "serve.fallbacks", "requests served by the fallback backend, per "
    "bucket")
_WORKER_RESTARTS = obs.registry().counter(
    "serve.worker_restarts", "supervised worker-thread restarts, per "
    "server (scope label)")

#: a batch closes early this far before its tightest member deadline, so
#: the request is dispatched *before* it would expire (the margin is the
#: larger of 2 ms and 10% of the request's whole deadline window)
_DEADLINE_SAFETY_FRAC = 0.1
_DEADLINE_SAFETY_MIN_S = 0.002


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """One request's answer: the program outputs (unbatched tensors on the
    session's device), the residual norm when the workload exposes a
    residual vector output, and how the request was served.  ``backend`` is the backend that actually served
    it; ``degraded`` is True when that was the fallback, not the
    requested backend."""
    outputs: Dict[str, Any]
    residual: Optional[float]
    bucket: str
    batch_size: int
    latency_s: float
    backend: str = ""
    degraded: bool = False


@dataclasses.dataclass
class _Item:
    """One queued request: the payload, its future, and its deadline
    (absolute ``time.monotonic`` seconds; ``inf`` = none)."""
    req: SolveRequest
    fut: "Future[SolveResult]"
    t_submit: float
    deadline: float = math.inf

    def close_by(self) -> float:
        """When the worker should stop coalescing on this item's account:
        safety-margin ahead of its deadline."""
        if self.deadline == math.inf:
            return math.inf
        margin = max(_DEADLINE_SAFETY_MIN_S,
                     _DEADLINE_SAFETY_FRAC * (self.deadline - self.t_submit))
        return max(self.t_submit, self.deadline - margin)


@dataclasses.dataclass
class _InFlightBatch:
    """The batch currently being served, tracked for crash supervision.
    ``accounted`` flips once ``_serve_batch`` has settled the in-flight /
    error counters, so the supervisor never double-counts."""
    key: BucketKey
    items: List[_Item]
    accounted: bool = False


class Server:
    """Batched, cached, concurrent plan serving over a ``PlanRouter``."""

    #: bucket-scheduling policies: ``oldest`` serves the bucket whose head
    #: request has waited longest (latency-greedy, can starve a cold
    #: bucket under sustained hot-bucket load within one wait window);
    #: ``round_robin`` serves the least-recently-served non-empty bucket,
    #: so every bucket makes progress regardless of arrival rates.
    POLICIES = ("oldest", "round_robin")

    #: what ``submit`` does when the queue holds ``max_queue`` requests
    OVERLOAD_POLICIES = ("block", "reject", "shed_oldest")

    def __init__(self, router: Optional[PlanRouter] = None,
                 config: Optional[ServeConfig] = None, *, session=None):
        # a config passed positionally lands in the router slot — shift it
        if isinstance(router, ServeConfig):
            if config is not None:
                raise TypeError("Server: got two configs (positional and "
                                "config=)")
            router, config = None, router
        cfg = config if config is not None else ServeConfig()
        if not isinstance(cfg, ServeConfig):
            raise TypeError(f"Server: config= takes a ServeConfig, got "
                            f"{type(cfg).__name__}")
        max_batch_size = cfg.max_batch_size
        max_wait_us = cfg.max_wait_us
        max_plans = cfg.max_plans
        autostart = cfg.autostart
        policy = cfg.policy
        max_queue = cfg.max_queue
        overload = cfg.overload
        retry = cfg.retry
        fallback = cfg.fallback
        breaker_failures = cfg.breaker_failures
        breaker_reset_s = cfg.breaker_reset_s
        max_worker_restarts = cfg.max_worker_restarts
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if max_wait_us < 0:
            raise ValueError("max_wait_us must be >= 0")
        if policy not in self.POLICIES:
            raise ValueError(f"unknown policy {policy!r}; "
                             f"have {self.POLICIES}")
        if overload not in self.OVERLOAD_POLICIES:
            raise ValueError(f"unknown overload policy {overload!r}; "
                             f"have {self.OVERLOAD_POLICIES}")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None: unbounded)")
        if breaker_failures is not None and breaker_failures < 1:
            raise ValueError("breaker_failures must be >= 1 (or None: "
                             "breaker disabled)")
        if max_worker_restarts < 0:
            raise ValueError("max_worker_restarts must be >= 0")
        self.policy = policy
        self._last_served: Dict[BucketKey, int] = {}
        self._serve_seq = 0
        self.router = router if router is not None else \
            PlanRouter(session=session, max_plans=max_plans)
        self.max_batch_size = max_batch_size
        self.max_wait_us = float(max_wait_us)
        self.max_queue = max_queue
        self.overload = overload
        self.retry = retry
        self.fallback = fallback
        self.breaker_failures = breaker_failures
        self.breaker_reset_s = float(breaker_reset_s)
        self.max_worker_restarts = max_worker_restarts
        self._cv = threading.Condition()
        self._pending: Dict[BucketKey, "deque[_Item]"] = {}
        self._closing = False
        self._down = False
        # counters/histograms live on the obs registry under this server's
        # scope label; every bump happens while holding _cv, so stats()
        # (which snapshots under _cv) is a consistent point-in-time view
        self._scope = obs.next_scope("serve")
        self._in_flight: Dict[str, int] = {}
        self._exec_stats: Dict[str, Dict[str, int]] = {}
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._current: Optional[_InFlightBatch] = None
        self._worker: Optional[threading.Thread] = None
        self._worker_restarts = 0
        self._started = False
        if autostart:
            self.start()

    # -- client surface -------------------------------------------------
    def start(self) -> "Server":
        """Start the worker (no-op when already running).  Construct with
        ``autostart=False`` + submit + ``start()`` to make coalescing
        deterministic — every queued request is visible before the first
        batch closes."""
        if not self._started:
            self._started = True
            with self._cv:
                self._worker = threading.Thread(target=self._worker_main,
                                                daemon=True,
                                                name="cello-serve-worker")
            self._worker.start()
        return self

    def submit(self, req: SolveRequest, *,
               deadline_s: Optional[float] = None) -> "Future[SolveResult]":
        """Enqueue one request; resolve/raise through the future.

        ``deadline_s`` (relative, from now) bounds how long the request
        may wait for dispatch: expiry fails *only* this request's future
        with :class:`DeadlineExceeded`; omitted, it defaults to the
        request's own ``deadline_s`` field.  A full queue is handled by
        the server's ``overload`` policy — ``reject`` raises
        :class:`Overloaded` here, in the caller.
        """
        if not isinstance(req, SolveRequest):
            raise TypeError(f"submit() takes a SolveRequest (see "
                            f"repro_torch.serve.request), got "
                            f"{type(req).__name__}")
        if deadline_s is None:
            deadline_s = req.deadline_s
        key = self.router.bucket(req)      # raises here, not on the worker
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")
        fut: "Future[SolveResult]" = Future()
        t_submit = time.monotonic()
        deadline = (t_submit + deadline_s if deadline_s is not None
                    else math.inf)
        with self._cv:
            while True:
                if self._closing:
                    raise ServerClosed("Server is closed")
                if self._down:
                    raise ServerClosed("Server worker is down (restarts "
                                       "exhausted); server is closed to "
                                       "new work")
                if self.max_queue is None:
                    break
                depth = sum(len(d) for d in self._pending.values())
                if depth < self.max_queue:
                    break
                if self.overload == "reject":
                    _REJECTED.inc(bucket=key.label, scope=self._scope)
                    raise Overloaded(f"queue full ({depth}/"
                                     f"{self.max_queue}); request rejected")
                if self.overload == "shed_oldest":
                    self._shed_oldest_locked()
                    continue
                # "block": wait for space, still honouring the deadline
                now = time.monotonic()
                if now > deadline:
                    _EXPIRED.inc(bucket=key.label, scope=self._scope)
                    raise DeadlineExceeded("deadline exceeded while "
                                           "blocked on admission")
                self._cv.wait(timeout=None if deadline == math.inf
                              else deadline - now)
            self._pending.setdefault(key, deque()).append(
                _Item(req, fut, t_submit, deadline))
            _REQUESTS.inc(bucket=key.label, scope=self._scope)
            self._cv.notify_all()
        return fut

    def solve(self, req: SolveRequest, *,
              deadline_s: Optional[float] = None) -> SolveResult:
        """Submit and wait: the synchronous convenience."""
        if not self._started:
            raise RuntimeError("Server not started (autostart=False): "
                               "call start() first")
        return self.submit(req, deadline_s=deadline_s).result()

    def health(self) -> Dict[str, Any]:
        """Liveness summary: ``status`` is ``ok`` (serving, nothing
        degraded), ``degraded`` (serving, but a breaker is not closed,
        the worker has been restarted, or a supervised restart is in
        progress), or ``down`` (not serving: never started, closed, or
        restarts exhausted)."""
        with self._cv:
            worker = self._worker
            alive = bool(worker is not None and worker.is_alive())
            # a replacement registered by the supervisor but not yet
            # running (ident is None): the server is restarting, not dead
            restarting = bool(worker is not None and worker.ident is None)
            restarts = self._worker_restarts
            breakers = {lb: b.state for lb, b in self._breakers.items()}
            closing, down, started = self._closing, self._down, self._started
        if down or closing or not started or not (alive or restarting):
            status = "down"
        elif restarts > 0 or restarting \
                or any(s != CircuitBreaker.CLOSED
                       for s in breakers.values()):
            status = "degraded"
        else:
            status = "ok"
        return {"status": status, "worker_alive": alive,
                "worker_restarts": restarts,
                "max_worker_restarts": self.max_worker_restarts,
                "breakers": breakers, "closing": closing, "down": down}

    def stats(self) -> Dict[str, Any]:
        """Merged router + queue + executable + robustness counters.

        **One locked snapshot**: queue depths, the obs-registry counters,
        the router's counters, and the executable's counters are all read
        while holding the server's condition variable — every write to any
        of them also happens under it, so the numbers reconcile exactly:
        ``requests == queued + in_flight + errors + Σ size·count`` over
        ``batch_sizes``, at any instant (shed / expired / crashed
        requests are inside ``errors``; ``rejected`` were never
        admitted).  Per-bucket ``latency`` / ``queue_wait`` are
        streaming-histogram summaries (p50/p90/p99 within the documented
        ±5% relative error).
        """
        with self._cv:
            queued = {k.label: len(d) for k, d in self._pending.items() if d}
            in_flight = {lb: n for lb, n in self._in_flight.items() if n}
            exec_stats = {lb: dict(s) for lb, s in self._exec_stats.items()}
            breakers = {lb: b.stats() for lb, b in self._breakers.items()}
            worker_restarts = self._worker_restarts
            snap = obs.snapshot(self._scope)
            rstats = self.router.stats()

        def cells(name: str):
            return snap.get(name, {}).get("cells", [])

        def per_bucket(name: str) -> Dict[str, Any]:
            return {c["labels"]["bucket"]: c["value"] for c in cells(name)}

        def per_bucket_int(name: str) -> Dict[str, int]:
            return {lb: int(v) for lb, v in per_bucket(name).items()}

        requests = per_bucket_int("serve.requests")
        batches = per_bucket_int("serve.batches")
        errors = per_bucket_int("serve.errors")
        rejected = per_bucket_int("serve.rejected")
        shed = per_bucket_int("serve.shed")
        expired = per_bucket_int("serve.deadline_missed")
        retries = per_bucket_int("serve.retries")
        fallbacks = per_bucket_int("serve.fallbacks")
        hist: Dict[str, Dict[int, int]] = {}
        for c in cells("serve.batch_size"):
            lb = c["labels"]["bucket"]
            hist.setdefault(lb, {})[int(c["labels"]["size"])] = \
                int(c["value"])
        latency = per_bucket("serve.e2e_latency_s")
        queue_wait = per_bucket("serve.queue_wait_s")
        labels = sorted(set(requests) | set(rstats["buckets"]) | set(queued)
                        | set(rejected))
        buckets = {}
        for lb in labels:
            r = rstats["buckets"].get(lb, {})
            e = exec_stats.get(lb, {})
            b = breakers.get(lb)
            buckets[lb] = {
                "requests": requests.get(lb, 0),
                "batches": batches.get(lb, 0),
                "batch_sizes": hist.get(lb, {}),
                "queued": queued.get(lb, 0),
                "in_flight": in_flight.get(lb, 0),
                "errors": errors.get(lb, 0),
                "rejected": rejected.get(lb, 0),
                "shed": shed.get(lb, 0),
                "deadline_missed": expired.get(lb, 0),
                "retries": retries.get(lb, 0),
                "fallbacks": fallbacks.get(lb, 0),
                "breaker": b["state"] if b else None,
                "breaker_opens": b["opens"] if b else 0,
                "cache_hits": r.get("cache_hits", 0),
                "cache_misses": r.get("cache_misses", 0),
                "dispatches": e.get("dispatches", 0),
                "traces": e.get("traces", 0),
                "latency": latency.get(lb),
                "queue_wait": queue_wait.get(lb),
            }
        return {
            "requests": sum(requests.values()),
            "batches": sum(batches.values()),
            "queue_depth": sum(queued.values()),
            "in_flight": sum(in_flight.values()),
            "errors": sum(errors.values()),
            "rejected": sum(rejected.values()),
            "shed": sum(shed.values()),
            "deadline_missed": sum(expired.values()),
            "retries": sum(retries.values()),
            "fallbacks": sum(fallbacks.values()),
            "worker_restarts": worker_restarts,
            "plans_cached": rstats["plans_cached"],
            "plan_evictions": rstats["evictions"],
            "buckets": buckets,
        }

    def close(self, *, flush: bool = True) -> None:
        """Stop accepting requests.  ``flush=True`` (default) serves
        everything already queued first; ``flush=False`` fails queued
        futures with a typed :class:`ServerClosed`."""
        dropped: List[_Item] = []
        with self._cv:
            self._closing = True
            # a never-started (or down) server has no worker to flush
            if not flush or not self._started or self._down:
                for k, d in self._pending.items():
                    for it in d:
                        _ERRORS.inc(bucket=k.label, scope=self._scope)
                        dropped.append(it)
                self._pending.clear()
            self._cv.notify_all()
        for it in dropped:
            self._settle_error(it.fut, ServerClosed(
                "Server closed before this request was served"))
        # join the worker; the supervisor may have swapped in a restarted
        # thread, so re-read until the joined thread is still the current
        # one (restarts stop once _closing is set).  The ident-is-None
        # wait is bounded: a replacement that was registered but whose
        # start() never ran (supervisor crashed between the two) would
        # otherwise spin this loop forever
        ident_wait_until = time.monotonic() + 1.0
        while self._started:
            with self._cv:
                w = self._worker
            if w is None:
                self._started = False
            elif w.ident is None:      # restart swapped in, not yet running
                if time.monotonic() > ident_wait_until:
                    with self._cv:     # never started: nothing to join
                        if self._worker is w:
                            self._started = False
                else:
                    time.sleep(0.001)
            else:
                w.join()
                ident_wait_until = time.monotonic() + 1.0
                with self._cv:
                    if self._worker is w:
                        self._started = False

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close(flush=exc == (None, None, None))

    # -- the worker loop -------------------------------------------------
    def _worker_main(self) -> None:
        try:
            self._loop()
        except BaseException as e:  # noqa: BLE001 — supervised
            self._on_worker_crash(e)

    def _loop(self) -> None:
        max_wait_s = self.max_wait_us * 1e-6
        while True:
            with self._cv:
                while True:
                    now = time.monotonic()
                    self._expire_locked(now)
                    if self._pending or self._closing:
                        break
                    self._cv.wait(timeout=self._expiry_timeout_locked(now))
                if not self._pending and self._closing:
                    return
                if not self._pending:      # everything just expired
                    continue
                live = [k for k, d in self._pending.items() if d]
                if self.policy == "round_robin":
                    # least-recently-served non-empty bucket (never-served
                    # sorts first); ties break oldest-head-first so the
                    # first pass through fresh buckets is still fair
                    key = min(live, key=lambda k: (
                        self._last_served.get(k, -1),
                        self._pending[k][0].t_submit))
                else:
                    # serve the bucket whose head request waited longest
                    key = min(live,
                              key=lambda k: self._pending[k][0].t_submit)
                self._serve_seq += 1
                self._last_served[key] = self._serve_seq
                # the max_wait window is anchored to the oldest request at
                # batch open, NOT the live head: if a deadline-bearing head
                # expires mid-wait the window must not restart, or requests
                # behind a chain of expiring heads wait >> max_wait
                anchor = self._pending[key][0].t_submit
                while (len(self._pending.get(key, ())) < self.max_batch_size
                       and not self._closing):
                    now = time.monotonic()
                    self._expire_locked(now)
                    d = self._pending.get(key)
                    if not d:
                        break
                    # close when the window anchor hits max_wait OR any
                    # member approaches its deadline (early, with margin,
                    # so it dispatches rather than expires)
                    close_at = min(anchor + max_wait_s,
                                   min(it.close_by() for it in d))
                    remaining = close_at - now
                    if remaining <= 0:
                        break
                    timeout = remaining
                    other = self._expiry_timeout_locked(now)
                    if other is not None:
                        timeout = min(timeout, other)
                    self._cv.wait(timeout=timeout)
                d = self._pending.get(key)
                if not d:
                    continue               # the whole bucket expired away
                batch = [d.popleft()
                         for _ in range(min(self.max_batch_size, len(d)))]
                if not d:
                    del self._pending[key]
                now = time.monotonic()
                lb = key.label
                kept = []
                for it in batch:
                    if now > it.deadline:
                        _EXPIRED.inc(bucket=lb, scope=self._scope)
                        _ERRORS.inc(bucket=lb, scope=self._scope)
                        self._settle_error(it.fut, DeadlineExceeded(
                            f"deadline exceeded after "
                            f"{now - it.t_submit:.3f}s in queue ({lb})"))
                    elif not it.fut.set_running_or_notify_cancel():
                        # client cancelled while queued: the cancel IS the
                        # settlement — drop the item, tally it as an error
                        _ERRORS.inc(bucket=lb, scope=self._scope)
                    else:
                        kept.append(it)
                batch = kept
                # queue space was freed: wake blocked submitters
                self._cv.notify_all()
                if not batch:
                    continue
                # queued -> in_flight atomically with the pop, so stats()
                # never sees these requests in neither state
                self._in_flight[lb] = self._in_flight.get(lb, 0) \
                    + len(batch)
                self._current = _InFlightBatch(key, batch)
            # crash-injection site: outside the lock, outside
            # _serve_batch's own error containment — exercises the
            # supervisor, not the per-batch error path
            faults.check("serve.worker", bucket=key.label)
            self._serve_batch(key, batch, time.monotonic())

    @staticmethod
    def _settle_error(fut: "Future[SolveResult]",
                      exc: BaseException) -> bool:
        """Deliver ``exc`` through ``fut`` unless the future already
        settled — a client ``cancel()`` may win at any moment while the
        future is still pending, and losing that race must never raise
        into the worker (or a submitter).  Returns True when delivered."""
        if fut.done():
            return False
        try:
            fut.set_exception(exc)
            return True
        except InvalidStateError:      # lost the race with a client cancel
            return False

    def _expire_locked(self, now: float) -> None:
        """Fail every queued request whose deadline has passed (strictly:
        ``now > deadline``) with a typed :class:`DeadlineExceeded`."""
        changed = False
        for key in list(self._pending):
            d = self._pending[key]
            if all(it.deadline >= now for it in d):
                continue
            keep: "deque[_Item]" = deque()
            lb = key.label
            for it in d:
                if now > it.deadline:
                    _EXPIRED.inc(bucket=lb, scope=self._scope)
                    _ERRORS.inc(bucket=lb, scope=self._scope)
                    self._settle_error(it.fut, DeadlineExceeded(
                        f"deadline exceeded after "
                        f"{now - it.t_submit:.3f}s in queue ({lb})"))
                    changed = True
                else:
                    keep.append(it)
            if keep:
                self._pending[key] = keep
            else:
                del self._pending[key]
        if changed:
            self._cv.notify_all()          # queue space freed

    def _expiry_timeout_locked(self, now: float) -> Optional[float]:
        """Seconds until the earliest queued deadline (None: no
        deadlines pending — wait indefinitely)."""
        nd = min((it.deadline for d in self._pending.values() for it in d),
                 default=math.inf)
        if nd == math.inf:
            return None
        return max(0.0, nd - now) + 1e-4

    def _shed_oldest_locked(self) -> None:
        """Fail the globally-oldest queued request with ``Overloaded`` to
        make room for a newer one (the shed_oldest admission policy)."""
        key = min((k for k, d in self._pending.items() if d),
                  key=lambda k: self._pending[k][0].t_submit)
        it = self._pending[key].popleft()
        if not self._pending[key]:
            del self._pending[key]
        lb = key.label
        _SHED.inc(bucket=lb, scope=self._scope)
        _ERRORS.inc(bucket=lb, scope=self._scope)
        # guarded: a concurrent client cancel() on the shed future must
        # not raise into this (unrelated) submitter's thread
        self._settle_error(it.fut, Overloaded(
            f"shed from the queue head ({lb}) to admit a newer request"))

    # -- supervision -----------------------------------------------------
    def _on_worker_crash(self, exc: BaseException) -> None:
        """The worker thread died outside the per-batch error path: fail
        exactly the in-flight futures, then restart (bounded) or mark the
        server down and fail everything queued."""
        failed: List[Any] = []
        restart: Optional[threading.Thread] = None
        with self._cv:
            self._worker_restarts += 1
            _WORKER_RESTARTS.inc(scope=self._scope)
            cur = self._current
            self._current = None
            if cur is not None:
                lb = cur.key.label
                undone = [it for it in cur.items if not it.fut.done()]
                if not cur.accounted:
                    self._in_flight[lb] = \
                        self._in_flight.get(lb, 0) - len(cur.items)
                    # once accounted, _serve_batch already tallied the
                    # batch (batch_sizes or errors) — bumping errors again
                    # here would double-count and break the stats invariant
                    if undone:
                        _ERRORS.inc(len(undone), bucket=lb,
                                    scope=self._scope)
                err = WorkerCrashed(
                    f"serve worker crashed mid-batch ({lb}): {exc!r}")
                err.__cause__ = exc
                failed += [(it.fut, err) for it in undone]
            if (not self._closing
                    and self._worker_restarts <= self.max_worker_restarts):
                restart = threading.Thread(target=self._worker_main,
                                           daemon=True,
                                           name="cello-serve-worker")
                self._worker = restart
            else:
                self._down = True
                drop_err = WorkerCrashed(
                    "serve worker is down (restarts exhausted); queued "
                    "request dropped un-served")
                drop_err.__cause__ = exc
                for k, d in self._pending.items():
                    for it in d:
                        _ERRORS.inc(bucket=k.label, scope=self._scope)
                        failed.append((it.fut, drop_err))
                self._pending.clear()
            self._cv.notify_all()
        # settle, then start the replacement under try/finally: if a
        # settle raised, a registered-but-never-started replacement would
        # wedge close() and leave the server silently dead
        try:
            for fut, e in failed:
                self._settle_error(fut, e)
        finally:
            if restart is not None:
                restart.start()

    # -- batch execution -------------------------------------------------
    def _breaker_for(self, lb: str) -> Optional[CircuitBreaker]:
        if not self.breaker_failures:
            return None
        with self._cv:
            b = self._breakers.get(lb)
            if b is None:
                b = CircuitBreaker(self.breaker_failures,
                                   self.breaker_reset_s,
                                   name=lb, scope=self._scope)
                self._breakers[lb] = b
            return b

    def _attempt(self, key: BucketKey, batch: List[_Item], lb: str):
        """One attempt at serving ``batch`` with ``key``'s plan (which
        may be the fallback variant — stats stay under the primary
        bucket's label ``lb``), on the calling thread's own CUDA stream
        when the router's session is on a card."""
        stream = _thread_stream(self.router.session.device)
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            return self._attempt_inner(key, batch, lb)

    def _attempt_inner(self, key: BucketKey, batch: List[_Item], lb: str):
        t0 = time.perf_counter()
        with obs.span("serve.batch_build", bucket=lb):
            entry = self.router.plan_for(key)
            per_request = [self.router.request_feeds(entry, it.req)
                           for it in batch]
        _BATCH_BUILD_S.observe(time.perf_counter() - t0,
                               bucket=lb, scope=self._scope)
        t0 = time.perf_counter()
        with obs.span("serve.dispatch", bucket=lb, size=len(batch)):
            outs = entry.bplan.run_many(per_request, entry.shared_feeds)
            # synced here, so the outputs are complete when the futures
            # resolve and the completion timestamps below are honest
            if entry.bplan.device.type == "cuda":
                torch.cuda.current_stream(entry.bplan.device).synchronize()
        _DISPATCH_S.observe(time.perf_counter() - t0,
                            bucket=lb, scope=self._scope)
        return entry, outs

    def _attempt_with_retries(self, key: BucketKey, batch: List[_Item],
                              lb: str):
        """Run ``_attempt`` under the server's RetryPolicy, through the
        shared ``run_with_restarts`` skeleton.  Returns ``(entry, outs)``;
        re-raises once retries are exhausted (each retry bumps
        ``serve.retries``)."""
        policy = self.retry
        if policy is None or policy.max_retries == 0:
            return self._attempt(key, batch, lb)
        result: Dict[str, Any] = {}
        state = {"retries": 0}

        def step(_step: int) -> None:
            try:
                result["v"] = self._attempt(key, batch, lb)
            except Exception as e:
                if not _kernel_failure(e):
                    raise
                result["kernel_failure"] = e          # not retried

        def restore(failed_step: int) -> int:
            state["retries"] += 1
            # counted here (not after the fact) so exhausted-retry
            # failures still show up in stats()
            _RETRIES.inc(bucket=lb, scope=self._scope)
            time.sleep(policy.delay_s(state["retries"]))
            return failed_step

        run_with_restarts(step, restore, 1,
                          max_restarts=policy.max_retries,
                          failure_types=(Exception,))
        if "kernel_failure" in result:
            raise result["kernel_failure"]
        return result["v"]

    def _serve_batch(self, key: BucketKey, batch: List[_Item],
                     t_close: float) -> None:
        lb = key.label
        n = len(batch)
        fell_back = False
        entry = outs = None
        primary_exc: Optional[BaseException] = None
        with obs.span("serve.batch", bucket=lb, size=n):
            breaker = self._breaker_for(lb)
            if breaker is None or breaker.allow():
                try:
                    entry, outs = self._attempt_with_retries(key, batch, lb)
                    if breaker is not None:
                        breaker.record_success()
                except BaseException as e:  # noqa: BLE001 — futures carry
                    primary_exc = e
                    if _kernel_failure(e):
                        # a kernel that does not build or launch raises:
                        # no plain version answers in its place
                        if breaker is not None:
                            breaker.release()
                    elif breaker is not None:
                        breaker.record_failure()
            if outs is None and self.fallback \
                    and key.backend != self.fallback \
                    and not _kernel_failure(primary_exc):
                fb_key = dataclasses.replace(key, backend=self.fallback)
                try:
                    with obs.span("serve.fallback", bucket=lb,
                                  backend=self.fallback):
                        entry, outs = self._attempt(fb_key, batch, lb)
                    fell_back = True
                except BaseException as e:  # noqa: BLE001
                    if primary_exc is None:
                        primary_exc = e
            if outs is None:
                if primary_exc is None:
                    # breaker open, primary skipped, no usable fallback
                    primary_exc = CircuitOpen(
                        f"circuit breaker open for bucket {lb} and no "
                        "usable fallback backend")
                with self._cv:
                    self._in_flight[lb] = self._in_flight.get(lb, 0) - n
                    _ERRORS.inc(n, bucket=lb, scope=self._scope)
                    if self._current is not None:
                        self._current.accounted = True
                for it in batch:
                    self._settle_error(it.fut, primary_exc)
                with self._cv:
                    self._current = None
                return
            done = time.monotonic()
            with self._cv:
                self._in_flight[lb] = self._in_flight.get(lb, 0) - n
                _BATCHES.inc(bucket=lb, scope=self._scope)
                _BATCH_SIZE.inc(bucket=lb, size=n, scope=self._scope)
                if fell_back:
                    _FALLBACKS.inc(n, bucket=lb, scope=self._scope)
                for it in batch:
                    _QUEUE_WAIT_S.observe(t_close - it.t_submit,
                                          bucket=lb, scope=self._scope)
                    _E2E_S.observe(done - it.t_submit,
                                   bucket=lb, scope=self._scope)
                self._exec_stats[lb] = dict(entry.bplan.stats)
                if self._current is not None:
                    self._current.accounted = True
        rname = entry.residual_output
        backend = entry.key.backend
        for it, out in zip(batch, outs):
            residual = None
            if rname is not None:
                residual = float(torch.linalg.vector_norm(out[rname]))
            try:
                it.fut.set_result(SolveResult(
                    outputs=out, residual=residual, bucket=lb,
                    batch_size=n, latency_s=done - it.t_submit,
                    backend=backend, degraded=fell_back))
            except InvalidStateError:  # pragma: no cover — running futures
                pass                   # cannot be cancelled; defensive only
        with self._cv:
            self._current = None


def _kernel_failure(e: Optional[BaseException]) -> bool:
    """Whether ``e``, or an exception it was raised from or during, is a
    kernel that did not build or launch."""
    seen = set()
    while e is not None and id(e) not in seen:
        if isinstance(e, KernelError):
            return True
        seen.add(id(e))
        e = e.__cause__ or e.__context__
    return False


_local = threading.local()


def _thread_stream(device) -> Optional["torch.cuda.Stream"]:
    """The calling thread's own stream on ``device`` (None off the card)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    streams = _local.__dict__.setdefault("streams", {})
    if dev not in streams:
        streams[dev] = torch.cuda.Stream(dev)
    return streams[dev]
