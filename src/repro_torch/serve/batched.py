"""`BatchedPlan`: one dispatch answers a whole batch of requests.

A compiled plan solves one problem instance per ``run()``.  Serving wants
the opposite shape: many user requests against the *same* operator (the
expensive, co-designed part) with different right-hand sides / starting
points (the cheap, per-request part).  The JAX package vmapped its
backend's pure single program over a leading batch axis; the port has no
vmap over its kernels, so ``BatchedPlan`` runs the backend's lane-batched
program (:meth:`repro_torch.exec.base.Executor.compile_batched`):

* **operator leaves are shared** — the dense ``A`` (or a CSR operand's
  indptr/indices/data sub-leaves) is passed once, at its traced shape,
  and every lane reads the same tensors.  ``shared=`` binds them when the
  plan is built (device tensors that every dispatch then passes, as the
  router does for a bucket): the ``cuda`` backend's graphs read them in
  place.  Unbound, each dispatch copies the operator in;
* **input leaves are batched** — each request contributes one row of
  ``b``, ``x0``, ... stacked on a new leading (lane) axis.

On the ``cuda`` backend a ``run_batch()`` is one CUDA-graph replay over
B1, B2 and B4 in their lane forms, whatever the batch size: the
serving-layer image of the one-replay-per-``run()`` guarantee, and
``stats`` mirrors its counters: ``dispatches`` counts ``run_batch``
calls, ``traces`` the distinct (lanes, dtype, leaf shapes) signatures
dispatched (one graph capture each on the ``cuda`` backend).
:meth:`run_many` pads a batch to a power of two, so a server sees at most
five signatures a dtype up to 16 lanes.  The JAX package's ``donate``
has no counterpart: the graph's buffers belong to the program.

Numerics: a lane runs the single request's arithmetic (the same row
blocks and reduction trees in B1, B2's entry order, B4's sweep), so a
lane equals :meth:`run_one` of its request bitwise on the CPU; on the
card that holds wherever the compiler keeps a lane's reductions in the
single pass's order (``chip_smoke.py`` records which held).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .. import obs
from ..exec import get_backend
from ..exec.base import plan_device, plan_program
from ..testing import faults

__all__ = ["BatchedPlan"]

_BP_TRACES = obs.registry().counter(
    "serve.batch_traces", "BatchedPlan signatures dispatched (one per "
    "distinct (lanes, dtype); a CUDA-graph capture each on the cuda "
    "backend), per plan (scope label)")
_BP_DISPATCHES = obs.registry().counter(
    "serve.batch_dispatches", "BatchedPlan coalesced-batch dispatches (a "
    "graph replay each on the cuda backend), per plan (scope label)")


class BatchedPlan:
    """Run a plan's lane-batched program over a request batch.

    ``feeds`` for :meth:`run_batch` carry every leaf of the program:
    operator leaves at their traced shape (shared across the batch), input
    leaves with one extra leading batch axis.  :meth:`run_many` stacks
    per-request feed dicts for you.  ``shared`` binds the operator leaves
    (see the module docstring).  Raises :class:`NotImplementedError`
    on the ``cuda`` backends for a plan whose spmv op holds an overbooked
    pin (B3 has no lane form yet).
    """

    def __init__(self, plan, *, backend: Optional[str] = None,
                 shared: Optional[Mapping[str, torch.Tensor]] = None):
        program = plan_program(plan)
        self.plan = plan
        self.program = program
        self.executor = get_backend(backend or plan.backend)
        self.backend = self.executor.name
        self.device = torch.device(plan_device(plan))
        leaves = program.leaves()
        self.shared_leaves = [nd.name for nd in leaves
                              if nd.op == "operator"]
        self.batched_leaves = [nd.name for nd in leaves
                               if nd.op != "operator"]
        if not self.batched_leaves:
            raise ValueError(f"{program.name!r} has no per-request (input) "
                             "leaves to batch over")
        self._batched = self.executor.compile_batched(
            plan, None if shared is None else dict(shared))
        # counters live on the obs registry under this plan's unique scope
        # label; ``stats`` reads them back as the familiar dict
        self._scope = obs.next_scope("batched")
        self._seen: set = set()
        self._lock = threading.Lock()
        # pinned host buffers that stage a batch's numpy feeds on their way
        # to the card: (leaf, lanes, dtype) -> [buffer, event after upload]
        self._staging: Dict[tuple, list] = {}
        self._staging_lock = threading.Lock()

    @property
    def stats(self) -> Dict[str, int]:
        """This plan's counters off the obs registry (dict-comparable)."""
        return {
            "traces": int(_BP_TRACES.value(backend=self.backend,
                                           scope=self._scope)),
            "dispatches": int(_BP_DISPATCHES.value(backend=self.backend,
                                                   scope=self._scope)),
        }

    @property
    def program_stats(self) -> Optional[Dict[str, Any]]:
        """The lane-batched program's own ``stats`` (runs, captures,
        replays, kernel launches) where the backend keeps them (``cuda``),
        else None."""
        return getattr(self._batched, "stats", None)

    # -- execution -------------------------------------------------------
    def run_batch(self, feeds: Mapping[str, Any]) -> Dict[str, Any]:
        """One dispatch over a stacked batch: ``{output: (B, ...) tensor}``
        on the plan's device.

        Shared (operator) leaves must come at their traced shape; batched
        (input) leaves with a consistent leading batch axis prepended.
        Feeds are tensors or numpy arrays (moved to the device).
        """
        shared: Dict[str, Any] = {}
        for n in self.shared_leaves:
            v = _require(feeds, n)
            want = self.program.nodes[n].shape
            if tuple(getattr(v, "shape", ())) != tuple(want):
                raise ValueError(
                    f"operator leaf {n!r} is shared across the batch: "
                    f"expected shape {tuple(want)}, got "
                    f"{tuple(getattr(v, 'shape', ()))} (pass it unbatched)")
            shared[n] = v
        batch = None
        batched: Dict[str, Any] = {}
        for n in self.batched_leaves:
            v = _require(feeds, n)
            want = self.program.nodes[n].shape
            shape = tuple(getattr(v, "shape", ()))
            if len(shape) != len(want) + 1 or shape[1:] != tuple(want):
                raise ValueError(
                    f"input leaf {n!r} must be batched: expected "
                    f"(B,) + {tuple(want)}, got {shape}")
            if batch is None:
                batch = shape[0]
            elif shape[0] != batch:
                raise ValueError(f"inconsistent batch sizes: leaf {n!r} "
                                 f"has {shape[0]}, expected {batch}")
            batched[n] = v
        sig = (batch, tuple((n, str(v.dtype), tuple(v.shape))
                            for n, v in {**shared, **batched}.items()))
        _BP_DISPATCHES.inc(backend=self.backend, scope=self._scope)
        with obs.span("serve.batch_dispatch", backend=self.backend,
                      batch=batch):
            # fault-injection site: serve.dispatch@<backend> — fail or
            # slow the coalesced dispatch itself
            faults.check("serve.dispatch", backend=self.backend)
            out = dict(self._batched(shared, batched))
        with self._lock:
            if sig not in self._seen:
                self._seen.add(sig)
                _BP_TRACES.inc(backend=self.backend, scope=self._scope)
        return out

    def run_many(self, requests: Sequence[Mapping[str, Any]],
                 shared: Mapping[str, Any], *,
                 pad: bool = True) -> List[Dict[str, Any]]:
        """Stack per-request feed dicts, dispatch once, unstack results.

        ``requests`` each map every batched (input) leaf to its unbatched
        value (numpy arrays or tensors); ``shared`` maps the operator
        leaves.  Returns one output dict per request: views of the batch's
        outputs on the plan's device.  For a plan on the card, numpy
        values are copied into a pinned host buffer kept per (leaf, lanes,
        dtype) and uploaded once, asynchronously (a fresh stacked array
        would cost its page faults and a pageable copy every batch).

        ``pad=True`` (default) rounds the batch up to the next power of
        two by repeating the last request, then drops the filler lanes:
        each new lane count costs a capture, so padding bounds the set to
        {1, 2, 4, ...} at ≤ 2× wasted lanes.  Lanes are independent, so
        filler lanes cannot perturb real ones.
        """
        if not requests:
            return []
        n_real = len(requests)
        n_lanes = _next_pow2(n_real) if pad else n_real
        feeds: Dict[str, Any] = dict(shared)
        for n in self.batched_leaves:
            vals = [_require(r, n) for r in requests]
            vals += [vals[-1]] * (n_lanes - n_real)
            if all(isinstance(v, torch.Tensor) for v in vals):
                feeds[n] = torch.stack(vals)
            elif self.device.type == "cuda":
                feeds[n] = self._staged(n, [np.asarray(v) for v in vals])
            else:
                feeds[n] = np.stack([np.asarray(v) for v in vals])
        out = self.run_batch(feeds)
        return [{k: v[i] for k, v in out.items()} for i in range(n_real)]

    def _staged(self, name: str, vals: List[np.ndarray]) -> torch.Tensor:
        """``vals`` stacked on the card: copied into the leaf's pinned
        buffer, then one non-blocking upload on the current stream.  The
        buffer is refilled only once the upload that last read it is
        done."""
        first = torch.from_numpy(np.ascontiguousarray(vals[0]))
        key = (name, len(vals), first.dtype)
        with self._staging_lock:
            ent = self._staging.get(key)
            if ent is None:
                ent = self._staging[key] = [torch.empty(
                    (len(vals), *first.shape), dtype=first.dtype,
                    pin_memory=True), None]
            buf, done = ent
            if done is not None:
                done.synchronize()
            for i, v in enumerate(vals):
                buf[i].copy_(torch.from_numpy(np.ascontiguousarray(v)))
            out = buf.to(self.device, non_blocking=True)
            ent[1] = torch.cuda.Event()
            ent[1].record(torch.cuda.current_stream(self.device))
        return out

    def run_one(self, feeds: Mapping[str, Any]) -> Dict[str, Any]:
        """The unbatched solve of one request on this plan's backend (its
        ``run()``): the sequential twin of one lane."""
        return self.executor.run(self.plan, dict(feeds))


def _require(feeds: Mapping[str, Any], name: str):
    if name not in feeds:
        raise KeyError(f"feeds missing leaf {name!r}")
    return feeds[name]


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()
