"""Executor interface + registry for plan execution backends.

The counterpart of ``repro.exec.base``.  A backend turns a lowered
:class:`~repro_torch.api.artifacts.CompiledPlan` for a frontend
(expression-DAG) trace into a computation::

    fn = get_backend("cuda").compile(plan)     # plan -> callable(feeds)
    outputs = fn(feeds)                        # {tensor name: tensor}

The contract every backend meets:

* it executes the plan's **co-designed group order** (the flattened fusion
  groups), not the program's build order,
* its outputs match the ``reference`` backend on the same feeds — bitwise
  for backends that replay the same per-op torch rules, within the
  reduction-reassociation tolerances for tiled backends.

Feeds are torch tensors (``frontends.reference.feeds_from_numpy``) or numpy
arrays, which a backend moves to its device; ``run()`` with no feeds makes
them from ``seed`` on the plan's device.

The shared ``run()`` path reports as the JAX package's does
(``repro/exec/base.py``): an ``exec.compile`` span around each memoized
compile, with the fault site ``exec.compile@<backend>``, and an
``exec.dispatch`` span around each call, with the site
``exec.dispatch@<backend>``; their wall-clock lands in the
``exec.compile_s`` and ``exec.run_s`` histograms (``repro_torch.obs``).
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence

from .. import obs
from ..testing import faults

Feeds = Dict[str, Any]
CompiledFn = Callable[[Feeds], Dict[str, Any]]
BatchedFn = Callable[[Feeds, Feeds], Dict[str, Any]]

_COMPILE_S = obs.registry().histogram(
    "exec.compile_s", "plan -> callable compile wall-clock (memoized: one "
    "observation per distinct plan per executor)", unit="s")
_RUN_S = obs.registry().histogram(
    "exec.run_s", "compiled-callable dispatch wall-clock (submit-side; "
    "CUDA launches are async, so device time may extend past this)",
    unit="s")


class Executor:
    """Protocol: compile a frontend plan into a callable and run it."""

    name: str = "base"

    def __init__(self) -> None:
        # compiled-plan cache keyed by plan *identity* (plan equality
        # ignores the carried trace/program, so two distinct programs can
        # compare equal); weakrefs keep dead plans from pinning entries.
        # The lock serializes lookup+compile+insert, so two threads racing
        # the same plan compile it once — the weakref finalizer's dict.pop
        # is atomic under the GIL and never takes the lock.
        self._compiled: Dict[int, tuple] = {}
        self._compile_lock = threading.Lock()

    # -- backend contract ----------------------------------------------
    def compile(self, plan) -> CompiledFn:
        """Lower ``plan`` to a callable ``feeds -> {name: value}``."""
        raise NotImplementedError

    def compile_batched(self, plan, shared=None) -> BatchedFn:
        """Lower ``plan`` to a lane-batched callable ``(shared, batched) ->
        {name: (L, ...) value}``: ``shared`` maps the operator leaves at
        their traced shape, ``batched`` every other leaf with a leading
        lane axis of length L, one request a lane
        (``repro_torch.serve.BatchedPlan`` batches through this hook).
        ``shared`` given here binds the operator: tensors on the plan's
        device that every call passes, which a backend may read in place
        (the ``cuda`` backend's graphs do); this default ignores it.

        The counterpart of the JAX package's ``compile_pure``, whose pure
        core ``jax.vmap`` batched; the port has no vmap over its kernels,
        so a backend returns the batched program itself.  This default
        runs :meth:`compile`'s callable once a lane and stacks the
        outputs; the ``cuda`` backends override it with their lane
        forms."""
        fn = self.compile(plan)

        def batched(shared, feeds):
            import torch
            n = {len(v) for v in feeds.values()}
            if len(n) != 1:
                raise ValueError(f"batched feeds disagree on the lane "
                                 f"count: {sorted(n)}")
            outs = [fn({**shared, **{k: v[i] for k, v in feeds.items()}})
                    for i in range(n.pop())]
            return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        return batched

    # -- shared driver --------------------------------------------------
    def compiled(self, plan) -> CompiledFn:
        """The memoized (thread-safe) compile of ``plan``."""
        with self._compile_lock:
            entry = self._compiled.get(id(plan))
            fn = (entry[1] if entry is not None and entry[0]() is plan
                  else None)
            if fn is None:
                t0 = time.perf_counter()
                with obs.span("exec.compile", backend=self.name):
                    # fault-injection site: exec.compile@<backend>
                    faults.check("exec.compile", backend=self.name)
                    fn = self.compile(plan)
                _COMPILE_S.observe(time.perf_counter() - t0,
                                   backend=self.name)
                try:
                    ref = weakref.ref(
                        plan,
                        lambda _, k=id(plan): self._compiled.pop(k, None))
                except TypeError:                    # not weakref-able
                    pass
                else:
                    self._compiled[id(plan)] = (ref, fn)
        return fn

    def run(self, plan, feeds: Optional[Feeds] = None, *,
            seed: int = 0) -> Dict[str, Any]:
        """Compile (memoized, thread-safe) and execute ``plan``."""
        program = plan_program(plan)
        fn = self.compiled(plan)
        if feeds is None:
            from ..frontends.reference import feeds_from_numpy, make_feeds
            feeds = feeds_from_numpy(make_feeds(program, seed),
                                     plan_device(plan))
        t0 = time.perf_counter()
        with obs.span("exec.dispatch", backend=self.name):
            # fault-injection site: exec.dispatch@<backend>
            faults.check("exec.dispatch", backend=self.name)
            out = fn(feeds)
        _RUN_S.observe(time.perf_counter() - t0, backend=self.name)
        return out

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r})"


# --------------------------------------------------------------------------
# plan plumbing shared by every backend
# --------------------------------------------------------------------------

def plan_program(plan):
    """The expression :class:`~repro_torch.frontends.expr.Program` behind
    ``plan`` (execution backends only run frontend-traced plans)."""
    if plan.trace is None or plan.trace.program is None:
        raise ValueError("execution backends need a frontend-traced plan "
                         "(Session.trace(workload=...) or "
                         "Session.from_graph(program))")
    return plan.trace.program


def plan_device(plan) -> str:
    """The torch device the plan's session runs on."""
    return plan.trace.session.device


def plan_shards(plan) -> int:
    """The shard count of a plan lowered with ``mesh=`` (1 without)."""
    sharded = getattr(plan, "sharded", None)
    return 1 if sharded is None else sharded.n_shards


def plan_groups(plan) -> List[List[str]]:
    """The co-designed fusion groups in scheduled order (each op its own
    group, in build order, when no search was run)."""
    program = plan_program(plan)
    if plan.codesigned is not None:
        return [list(g) for g in plan.codesigned.best.schedule.groups]
    return [[n] for n in program.schedulable_order()]


def plan_order(plan) -> List[str]:
    """The flattened scheduled op order."""
    return [o for g in plan_groups(plan) for o in g]


# --------------------------------------------------------------------------
# registry (mirrors core.search.SearchStrategy)
# --------------------------------------------------------------------------

EXECUTOR_REGISTRY: Dict[str, Executor] = {}


def register_backend(backend):
    """Register a backend instance (or class, instantiated with no args)."""
    inst = backend() if isinstance(backend, type) else backend
    EXECUTOR_REGISTRY[inst.name] = inst
    return backend


def get_backend(name_or_obj) -> Executor:
    if isinstance(name_or_obj, str):
        if name_or_obj not in EXECUTOR_REGISTRY:
            raise KeyError(f"unknown execution backend {name_or_obj!r}; "
                           f"have {sorted(EXECUTOR_REGISTRY)}")
        return EXECUTOR_REGISTRY[name_or_obj]
    if isinstance(name_or_obj, type):    # mirror register_backend: a bare
        return name_or_obj()             # class is instantiated with no args
    return name_or_obj


def list_backends() -> Sequence[str]:
    return sorted(EXECUTOR_REGISTRY)
