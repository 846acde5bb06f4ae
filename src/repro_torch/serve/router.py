"""Request → bucket key → resident `BatchedPlan`: the serving hot path.

A copy of ``repro.serve.router``.  Requests name a problem *family*, not a
plan: ``(workload, params, dtype, density bucket, backend)``.  The router
canonicalizes that into a :class:`BucketKey` — workload params resolved
against the workload function's defaults (so ``cg_sparse(n=256)`` and
``cg_sparse(n=256, pattern="laplacian5")`` share a bucket) and sparse
``density`` snapped to a decade bucket (:func:`density_bucket`).  The keys
and their labels are the JAX package's, letter for letter.

A bounded LRU of :class:`~repro_torch.serve.batched.BatchedPlan`\\ s sits
on top: a hot bucket costs one dict lookup (zero search, zero trace, zero
compile); a cold bucket pays trace → codesign → lower → compile once,
then stays resident until evicted.  The session's codesign disk cache
(``api.cache``) replays a search that another bucket of the same
(workload, params) ran, such as a bucket's fallback variant (another
backend) or its other dtype.  A resident bucket holds its shared
operator on the session's device, uploaded once and bound to its batched
plan, whose graphs read it in place: every batch hands the plan those
tensors (the JAX package handed numpy feeds to every dispatch, which on
a card would move cg's 64 MiB ``A`` over PCIe for every batch).  All
router state is guarded by one lock — worker threads and callers can
route concurrently.
"""
from __future__ import annotations

import dataclasses
import inspect
import math
import threading
from collections import OrderedDict
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..exec.base import plan_device, plan_program
from .batched import BatchedPlan

__all__ = ["SolveRequest", "request", "BucketKey", "density_bucket",
           "PlanRouter"]

_PLAN_HITS = obs.registry().counter(
    "serve.plan_cache.hits", "resident BatchedPlan LRU hits, per bucket "
    "and router (scope label)")
_PLAN_MISSES = obs.registry().counter(
    "serve.plan_cache.misses", "resident-plan LRU misses (a cold bucket "
    "pays trace -> codesign -> lower -> compile)")
_PLAN_EVICTIONS = obs.registry().counter(
    "serve.plan_cache.evictions", "resident plans evicted by the LRU bound")
_PLANS_RESIDENT = obs.registry().gauge(
    "serve.plans_resident", "currently resident compiled plans")


def density_bucket(density: float) -> float:
    """Snap a sparse density to its decade bucket: ``10 ** round(log10)``.

    ``0.0008``–``0.003`` (roughly) all route to ``1e-3``: one plan serves
    the decade, and the bucket's canonical density sizes its operand.
    """
    density = float(density)
    if not 0.0 < density <= 1.0:
        raise ValueError(f"density must be in (0, 1], got {density}")
    return min(1.0, 10.0 ** round(math.log10(density)))


@dataclasses.dataclass(frozen=True)
class BucketKey:
    """Canonical identity of one servable plan variant."""
    workload: str
    params: Tuple[Tuple[str, Any], ...]    # canonicalized, sorted
    dtype: str                             # numpy name: "float32"
    density: str          # "dense" | "d0.001" | "laplacian5" | "banded/b64"
    backend: str

    @property
    def label(self) -> str:
        """Compact stable string — the per-bucket stats key."""
        params = ", ".join(f"{k}={v}" for k, v in self.params
                           if v is not None)
        return (f"{self.workload}({params})/{self.dtype}"
                f"/{self.density}/{self.backend}")


@dataclasses.dataclass(frozen=True)
class SolveRequest:
    """One user request: a problem family plus per-request inputs (numpy
    arrays in ``feeds``).

    ``seed`` generates deterministic input-leaf feeds; ``feeds`` overlays
    explicit values for (a subset of) the input leaves — the operator is
    always the bucket's shared one, that is the point of bucketing.
    """
    workload: str
    params: Tuple[Tuple[str, Any], ...] = ()
    dtype: str = "float32"
    backend: str = "reference"
    seed: int = 0
    feeds: Optional[Mapping[str, Any]] = dataclasses.field(
        default=None, compare=False)
    # per-request serving deadline (seconds from submit); None = the
    # server's default.  Serving metadata, not bucket identity.
    deadline_s: Optional[float] = dataclasses.field(
        default=None, compare=False)

    def bucket(self) -> BucketKey:
        """Canonical bucket key for this request (raises early on
        unknown workloads/params — before anything is queued)."""
        from ..frontends.hpc import WORKLOADS
        if self.workload not in WORKLOADS:
            raise KeyError(f"unknown HPC workload {self.workload!r}; "
                           f"have {sorted(WORKLOADS)}")
        sig = inspect.signature(WORKLOADS[self.workload])
        try:
            bound = sig.bind(**dict(self.params))
        except TypeError as e:
            raise TypeError(f"workload {self.workload!r}: {e}") from None
        bound.apply_defaults()
        params = dict(bound.arguments)
        density = params.get("density")
        if density is not None:
            bucketed = density_bucket(density)
            params["density"] = bucketed
            dlabel = f"d{bucketed:g}"
        elif "pattern" in params:
            dlabel = str(params["pattern"])
            if params.get("bandwidth") is not None:
                dlabel += f"/b{params['bandwidth']}"
        else:
            dlabel = "dense"
        dt = np.dtype(self.dtype)
        if dt.kind != "f":
            raise ValueError(f"request dtype must be a float dtype, "
                             f"got {self.dtype}")
        return BucketKey(workload=self.workload,
                         params=tuple(sorted(params.items())),
                         dtype=dt.name, density=dlabel,
                         backend=self.backend)


def request(workload: str, *, dtype: str = "float32",
            backend: str = "reference", seed: int = 0,
            feeds: Optional[Mapping[str, Any]] = None,
            deadline_s: Optional[float] = None,
            **params) -> SolveRequest:
    """Build a :class:`SolveRequest`; workload params go as kwargs::

        request("cg", n=256, iters=4, seed=7)
        request("cg_sparse", n=256, density=1e-3, dtype="float64")
    """
    dt = np.dtype(dtype)
    if dt.kind != "f":
        raise ValueError(f"request dtype must be a float dtype, got {dtype}")
    return SolveRequest(workload=workload,
                        params=tuple(sorted(params.items())),
                        dtype=dt.name, backend=backend, seed=seed,
                        feeds=feeds, deadline_s=deadline_s)


class _PlanEntry:
    """One resident bucket: the batched plan + its shared operator feeds,
    on the plan's device."""

    def __init__(self, key: BucketKey, plan, np_dtype):
        self.key = key
        self.np_dtype = np_dtype
        self.program = plan_program(plan)
        device = torch.device(plan_device(plan))
        from ..frontends.reference import feeds_from_numpy, make_feeds
        # the bucket's operator is fixed (seed 0): every request in the
        # bucket solves against the same shared operand — generated and
        # uploaded once, bound to the batched plan (whose graphs read it in
        # place) and handed to every batch as the same tensors
        self.shared_feeds = feeds_from_numpy(
            make_feeds(self.program, seed=0, dtype=np_dtype,
                       only=[nd.name for nd in self.program.leaves()
                             if nd.op == "operator"]), device)
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        self.bplan = BatchedPlan(plan, shared=self.shared_feeds)
        self.residual_output = _residual_output(self.program)


def _residual_output(program) -> Optional[str]:
    """The latest residual-vector output (``r<k>``), if the workload
    exposes one — Krylov workloads output ``(x{k}, r{k})``."""
    import re
    cands = [(int(m.group(1)), o) for o in program.outputs
             for m in [re.fullmatch(r"r(\d+)", o)] if m is not None]
    return max(cands)[1] if cands else None


class PlanRouter:
    """Bounded LRU of compiled ``BatchedPlan``s, keyed by bucket."""

    def __init__(self, session=None, *, max_plans: int = 8):
        if session is None:
            from ..api.session import Session
            session = Session()                  # on the card
        if max_plans < 1:
            raise ValueError("max_plans must be >= 1")
        self.session = session
        self.max_plans = max_plans
        self._lru: "OrderedDict[BucketKey, _PlanEntry]" = OrderedDict()
        self._lock = threading.RLock()
        # hit/miss/eviction counters live on the obs registry under this
        # router's unique scope label; stats() reads them back
        self._scope = obs.next_scope("router")

    @property
    def evictions(self) -> int:
        return int(_PLAN_EVICTIONS.value(scope=self._scope))

    # -- canonicalization ----------------------------------------------
    def bucket(self, req: SolveRequest) -> BucketKey:
        """Canonical bucket key for a request — delegates to
        :meth:`SolveRequest.bucket` (kept as a router method so callers
        holding only a router keep working)."""
        return req.bucket()

    # -- the cache ------------------------------------------------------
    def plan_for(self, key: BucketKey) -> _PlanEntry:
        """The bucket's resident entry — compiled on first use, then LRU.

        The lock spans lookup+build+insert: two threads racing a cold
        bucket build it once (compiles serialize — the codesign disk
        cache and ``Session.trace`` memo make the loser's path cheap
        anyway).
        """
        with self._lock:
            entry = self._lru.get(key)
            if entry is not None:
                self._lru.move_to_end(key)
                _PLAN_HITS.inc(bucket=key.label, scope=self._scope)
                return entry
            _PLAN_MISSES.inc(bucket=key.label, scope=self._scope)
            with obs.span("serve.plan_build", bucket=key.label):
                entry = self._build(key)
            self._lru[key] = entry
            while len(self._lru) > self.max_plans:
                self._lru.popitem(last=False)
                _PLAN_EVICTIONS.inc(scope=self._scope)
            _PLANS_RESIDENT.set(len(self._lru), scope=self._scope)
            return entry

    def _build(self, key: BucketKey) -> _PlanEntry:
        traced = self.session.trace(workload=key.workload,
                                    **dict(key.params))
        plan = traced.codesign().lower(backend=key.backend)
        return _PlanEntry(key, plan, np.dtype(key.dtype))

    def request_feeds(self, entry: _PlanEntry,
                      req: SolveRequest) -> Dict[str, Any]:
        """Per-request values for the batched (input) leaves only:
        deterministic from ``req.seed``, overlaid with ``req.feeds`` (a
        leaf the request sets is not generated)."""
        from ..frontends.reference import make_feeds
        given = req.feeds or {}
        feeds = make_feeds(entry.program, seed=req.seed,
                           dtype=entry.np_dtype,
                           only=[n for n in entry.bplan.batched_leaves
                                 if n not in given])
        if req.feeds:
            batched = set(entry.bplan.batched_leaves)
            for name, val in req.feeds.items():
                if name not in batched:
                    raise KeyError(
                        f"request feeds may only set input leaves "
                        f"{sorted(batched)}; {name!r} is "
                        + ("the bucket's shared operator"
                           if name in entry.bplan.shared_leaves
                           else "not a leaf"))
                want = entry.program.nodes[name].shape
                val = np.asarray(val)
                if val.shape != tuple(want):
                    raise ValueError(f"feed {name!r}: expected shape "
                                     f"{tuple(want)}, got {val.shape}")
                if val.dtype.kind == "f":
                    val = val.astype(entry.np_dtype, copy=False)
                feeds[name] = val
        return feeds

    def stats(self) -> Dict[str, Any]:
        # one consistent read: the LRU size and the registry snapshot are
        # taken under the router lock (every counter bump happens under it
        # too, so no hit/miss can land between the two reads)
        with self._lock:
            plans_cached = len(self._lru)
            snap = obs.snapshot(self._scope)

        def per_bucket(name: str) -> Dict[str, int]:
            return {c["labels"]["bucket"]: int(c["value"])
                    for c in snap.get(name, {}).get("cells", [])}

        hits = per_bucket("serve.plan_cache.hits")
        misses = per_bucket("serve.plan_cache.misses")
        evictions = sum(
            int(c["value"]) for c in
            snap.get("serve.plan_cache.evictions", {}).get("cells", []))
        labels = sorted(set(hits) | set(misses))
        return {
            "plans_cached": plans_cached,
            "max_plans": self.max_plans,
            "evictions": evictions,
            "buckets": {lb: {"cache_hits": hits.get(lb, 0),
                             "cache_misses": misses.get(lb, 0)}
                        for lb in labels},
        }
