"""The ``cuda`` execution backend: a co-designed plan on hand-written
Hopper kernels.

The counterpart of ``repro.exec.pallas``'s single-program executable
(``_SingleProgram``, ``repro/exec/pallas.py:810-970``).  JAX traced the
whole plan into one ``jax.jit``; here an eager driver walks the plan's
execution units (``core.lowering.plan_execution``) and launches a kernel
per unit on the current CUDA stream:

* ``stream`` units run as one B1 pass (``kernels.stream``, generated
  Triton); their spmv ops first run as CUDA C++ launches
  (``kernels.spmv``) whose outputs the pass streams: B3 for an op whose
  operand holds an overbooked (prefix) pin that the arrangement accepts
  (:func:`spmv_prefixes`), B2 for every other;
* ``block`` units run each ``stencil2d`` op as a B4 launch
  (``kernels.stencil``, CUDA C++), ping-ponging between scratch buffers,
  and each run of same-shape elementwise ops as a B1 pass over the
  flattened arrays;
* ``jnp`` units (scalar-only glue, mttkrp's 3-operand einsum) run the
  reference rules as plain torch ops on device tensors, as the JAX
  package ran them outside Pallas;
* a rolled loop (``RolledLoop``) replays its template units
  ``roll.n_iters`` times over the carried tensors.

Nothing in ``run()`` waits for the device: scalars stay 1-element device
tensors and no value is read back on the host, so the host enqueues the
whole plan and returns.  ``stats`` counts runs and kernel launches,
each run's launches on its own thread (``kernels.counting``).

On CPU tensors every kernel wrapper runs its plain version, so the same
driver runs here on the CPU (the tests use it that way, with
``Session(device="cpu")``).
"""
from __future__ import annotations

import collections
import functools
import threading
from typing import Any, Dict, List, Optional, Set, Tuple

import torch

from .. import kernels
from ..kernels.spmv import arrange, spmv
from ..kernels.stencil import stencil2d
from ..kernels.stream import StreamKernel
from .base import Executor, plan_device, plan_program
from .reference import as_tensor, eval_node


def spmv_prefixes(program, sp) -> Dict[str, Optional[int]]:
    """Every spmv op of the stream pass ``sp`` with the resident prefix
    (rows) that B3 runs it with, or None where it runs on B2: its operand
    holds no prefix slice, or the arrangement declines it (as the JAX
    package's ``_StreamCall`` does at ``repro/exec/pallas.py:224-241``)."""
    slice_of = {t: sl for sl in sp.slices for t in sl.tensors}
    out: Dict[str, Optional[int]] = {}
    for o in sp.ops:
        nd = program.nodes[o]
        if nd.op != "spmv":
            continue
        sl = slice_of.get(nd.inputs[0])
        out[o] = None if sl is None else arrange(
            sl, program.nodes.get(nd.inputs[0]), sp.rows, sp.tile_rows,
            program.nodes[nd.inputs[1]].shape[0])
    return out


class _StreamUnit:
    """A ``stream`` unit: B3 or B2 launches for its spmv ops, then one B1
    pass."""

    def __init__(self, program, unit, needed: Set[str]):
        sp = unit.sp
        nodes = [program.nodes[o] for o in sp.ops]
        self.spmv_nodes = [nd for nd in nodes if nd.op == "spmv"]
        self.prefix = spmv_prefixes(program, sp)
        rest = [nd for nd in nodes if nd.op != "spmv"]
        shapes = {n: program.nodes[n].shape
                  for nd in nodes for n in (*nd.inputs, nd.name)}
        self.pass_ = (StreamKernel(rest, shapes, needed, sp.rows)
                      if rest else None)
        self.spmv_out = [nd.name for nd in self.spmv_nodes
                         if nd.name in needed]
        produced = {nd.name for nd in nodes}
        self.in_names = list(dict.fromkeys(
            t for nd in nodes for t in nd.inputs if t not in produced))

    def __call__(self, env: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        vals = {nd.name: spmv(*(env[t] for t in nd.inputs),
                              rows=nd.shape[0],
                              prefix_rows=self.prefix[nd.name])
                for nd in self.spmv_nodes}
        out = {n: vals[n] for n in self.spmv_out}
        if self.pass_ is not None:
            out.update(self.pass_(collections.ChainMap(vals, env)))
        return out


class _BlockUnit:
    """A ``block`` unit: B4 per stencil op, B1 over flattened arrays per run
    of elementwise ops.  Stencil results read only inside the unit live in
    scratch buffers that are reused once dead (two suffice for a chain)."""

    def __init__(self, program, unit, needed: Set[str]):
        nodes = [program.nodes[o] for o in unit.ops]
        produced = {nd.name for nd in nodes}
        self.in_names = list(dict.fromkeys(
            t for nd in nodes for t in nd.inputs if t not in produced))
        self.out_names = [nd.name for nd in nodes if nd.name in needed]
        steps: List[Tuple[str, Any]] = []
        run: List[Any] = []

        def flush():
            if not run:
                return
            names = [nd.name for nd in run]
            later = {t for nd in nodes[nodes.index(run[-1]) + 1:]
                     for t in nd.inputs}
            keep = {n for n in names if n in needed or n in later}
            shapes = {n: ((int(torch.Size(program.nodes[n].shape).numel()),)
                          if program.nodes[n].shape else ())
                      for nd in run for n in (*nd.inputs, nd.name)}
            rows = shapes[names[0]][0]
            steps.append(("stream", StreamKernel(list(run), shapes, keep,
                                                 rows)))
            run.clear()

        for nd in nodes:
            if nd.op == "stencil2d":
                flush()
                steps.append(("stencil", nd))
            else:
                run.append(nd)
        flush()
        self.steps = steps
        # last step reading each tensor, for scratch reuse
        self.last_read: Dict[str, int] = {}
        for si, (kind, obj) in enumerate(steps):
            reads = obj.in_names if kind == "stream" else obj.inputs
            for t in reads:
                self.last_read[t] = si
        self.needed = needed
        self.shapes = {nd.name: nd.shape for nd in nodes}

    def __call__(self, env: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        vals: Dict[str, torch.Tensor] = {}
        scratch: Dict[str, torch.Tensor] = {}    # stencil outputs it owns
        free: List[torch.Tensor] = []

        def get(t):
            return vals[t] if t in vals else env[t]

        for si, (kind, obj) in enumerate(self.steps):
            if kind == "stencil":
                nd = obj
                out = None
                if nd.name not in self.needed and free:
                    out = free.pop()
                u = get(nd.inputs[0])
                f = get(nd.inputs[1]) if len(nd.inputs) > 1 else None
                vals[nd.name] = stencil2d(u, f, nd.param("h2", 1.0), out=out)
                if nd.name not in self.needed:
                    scratch[nd.name] = vals[nd.name]
            else:
                flat = {t: get(t).reshape(-1) if get(t).dim() else get(t)
                        for t in obj.in_names}
                for n, v in obj(flat).items():
                    vals[n] = v.reshape(self.shapes[n])
            for t, buf in list(scratch.items()):
                if self.last_read.get(t, -1) <= si:
                    free.append(buf)
                    del scratch[t]
        return {n: vals[n] for n in self.out_names}


class _TorchUnit:
    """A ``jnp`` unit: the reference rules as plain torch ops."""

    def __init__(self, program, unit, needed: Set[str]):
        self.nodes = [program.nodes[o] for o in unit.ops]
        produced = {nd.name for nd in self.nodes}
        self.in_names = list(dict.fromkeys(
            t for nd in self.nodes for t in nd.inputs if t not in produced))
        self.out_names = [nd.name for nd in self.nodes if nd.name in needed]

    def __call__(self, env: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        vals: Dict[str, torch.Tensor] = {}
        for nd in self.nodes:
            vals[nd.name] = eval_node(
                nd, [vals[t] if t in vals else env[t] for t in nd.inputs])
        return {n: vals[n] for n in self.out_names}


def _build_unit(program, unit, needed: Set[str]):
    if unit.kind == "stream":
        return _StreamUnit(program, unit, needed)
    if unit.kind == "block":
        return _BlockUnit(program, unit, needed)
    return _TorchUnit(program, unit, needed)


# --------------------------------------------------------------------------
# the executable
# --------------------------------------------------------------------------

def _unit_needed(program, units) -> List[Set[str]]:
    """Per-unit "read outside this unit" sets over the straight-line unit
    sequence (program outputs always count)."""
    outputs = set(program.outputs)
    consumers: Dict[str, List[int]] = {}
    for ui, unit in enumerate(units):
        for o in unit.ops:
            for t in program.nodes[o].inputs:
                consumers.setdefault(t, []).append(ui)
    return [{o for o in unit.ops
             if o in outputs or any(c > ui for c in consumers.get(o, ()))}
            for ui, unit in enumerate(units)]


class CudaProgram:
    """One compiled plan: ``feeds -> {output: tensor}`` on its device."""

    def __init__(self, plan):
        program = plan_program(plan)
        ep = plan.exec_plan
        if ep is None:
            raise ValueError("the cuda backend runs plans lowered by "
                             "Session.lower (they carry an ExecPlan)")
        self.exec_plan = ep
        self.device = torch.device(plan_device(plan))
        units, roll = ep.units, ep.roll
        needed = _unit_needed(program, units)
        if roll is not None:
            # loop-carried values must leave their units even when the
            # straight-line view says nothing later reads them
            updates = {sl.update for sl in roll.slots}
            inits = {sl.init for sl in roll.slots if sl.init is not None}
            for ui in range(roll.first, roll.first + roll.per_iter):
                needed[ui] = needed[ui] | (updates & set(units[ui].ops))
            for ui in range(roll.first):
                needed[ui] = needed[ui] | (inits & set(units[ui].ops))
            pro = range(roll.first)
            tmpl = range(roll.first, roll.first + roll.per_iter)
            epi = range(roll.stop, len(units))
        else:
            pro, tmpl, epi = range(len(units)), (), ()
        self._pro = [_build_unit(program, units[i], needed[i]) for i in pro]
        self._tmpl = [_build_unit(program, units[i], needed[i])
                      for i in tmpl]
        self._epi = [_build_unit(program, units[i], needed[i]) for i in epi]
        self.roll = roll
        self.leaf_names = [nd.name for nd in program.leaves()]
        self.out_names = list(program.outputs)
        if roll is not None:
            tmpl_ops = {o for i in tmpl for o in units[i].ops}
            reads = {sl.read for sl in roll.slots if sl.read is not None}
            self._tmpl_ext = list(dict.fromkeys(
                n for call in self._tmpl for n in call.in_names
                if n not in tmpl_ops and n not in reads))
            self._slot_shapes = [program.nodes[sl.update].shape
                                 for sl in roll.slots]
        self._runs = 0
        self._launches = dict.fromkeys(kernels.LAUNCHES, 0)
        self._stats_lock = threading.Lock()

    @property
    def stats(self) -> Dict[str, Any]:
        """Runs of this program and the kernel launches they made, each
        run's counted on the thread that made it (``kernels.counting``),
        so runs on other threads at the same time do not mix in."""
        with self._stats_lock:
            return {"runs": self._runs, "launches": dict(self._launches)}

    def _leaves(self, feeds) -> Tuple[Dict[str, torch.Tensor], torch.dtype]:
        env: Dict[str, torch.Tensor] = {}
        for leaf in self.leaf_names:
            if leaf not in feeds:
                raise KeyError(f"feeds missing leaf {leaf!r}")
            env[leaf] = as_tensor(feeds[leaf], self.device)
        float_dts = [v.dtype for v in env.values() if v.is_floating_point()]
        # one float dtype per run, resolved from the leaves; integer leaves
        # (CSR indptr/indices) keep their own
        dtype = (functools.reduce(torch.promote_types, float_dts)
                 if float_dts else torch.float32)
        for name, v in env.items():
            if v.is_floating_point():
                env[name] = v.to(dtype).contiguous()
            else:
                env[name] = v.contiguous()
        return env, dtype

    def __call__(self, feeds) -> Dict[str, torch.Tensor]:
        with kernels.counting() as made:
            out = self._run(feeds)
        with self._stats_lock:
            self._runs += 1
            for k, v in made.items():
                self._launches[k] += v
        return out

    def _run(self, feeds) -> Dict[str, torch.Tensor]:
        env, dtype = self._leaves(feeds)
        for call in self._pro:
            env.update(call(env))
        if self.roll is not None:
            slots = self.roll.slots
            base = {n: env[n] for n in self._tmpl_ext}
            # output-only slots (init=None) seed with zeros: their carry-in
            # is never read, only their final generation leaves the loop
            carry = [env[sl.init] if sl.init is not None
                     else torch.zeros(shape, dtype=dtype, device=self.device)
                     for sl, shape in zip(slots, self._slot_shapes)]
            for _ in range(self.roll.n_iters):
                env_l = dict(base)
                for sl, v in zip(slots, carry):
                    if sl.read is not None:
                        env_l[sl.read] = v
                for call in self._tmpl:
                    env_l.update(call(env_l))
                carry = [env_l[sl.update] for sl in slots]
            for sl, v in zip(slots, carry):
                env[sl.final] = v
        for call in self._epi:
            env.update(call(env))
        return {o: env[o] for o in self.out_names}


class CudaExecutor(Executor):
    """Run the plan's units on the hand-written Hopper kernels."""

    name = "cuda"

    def compile(self, plan) -> CudaProgram:
        return CudaProgram(plan)
