"""The ``cuda`` execution backend: a co-designed plan on hand-written
Hopper kernels, one CUDA-graph replay per ``run()``.

The counterpart of ``repro.exec.pallas``'s single-program executable
(``_SingleProgram``, ``repro/exec/pallas.py:810-970``).  JAX traced the
whole plan into one ``jax.jit``; here the program walks the plan's
execution units (``core.lowering.plan_execution``), launching a kernel
per unit on the current CUDA stream, captures that walk into one
``torch.cuda.CUDAGraph`` per signature and replays it:

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

Nothing in the walk waits for the device: scalars stay 1-element device
tensors and no value is read back on the host, which is what lets it be
captured.  A signature is the run's float dtype and every leaf's shape and
dtype.  The first ``run()`` of a signature walks the units once eagerly on
a side stream (that builds the ``nvcc`` library and compiles the Triton
passes, which a capture cannot do), then captures the walk into a graph
whose inputs are program-owned leaf buffers.  Every run copies its feeds
into those buffers, replays the graph once and returns clones of the
graph's output buffers, so a caller's outputs outlive later runs.  A
rolled loop is captured unrolled: the graph grows with ``n_iters``.  A
capture that fails raises; the eager walk is the ``cuda-perunit`` backend,
which a caller picks by name.  Runs of one program on several threads (each
on its own stream) take the program's lock in turn, and each waits on an
event that the previous run recorded after its copy-out, so no run
rewrites the buffers that an earlier replay still reads.

``stats`` counts runs, ``traces`` (captures) and ``dispatches`` (replays),
read from the ``exec.traces`` and ``exec.dispatches`` counters under the
program's own ``obs`` scope, as the JAX package's ``stats`` are
(``dispatches == runs``, ``traces`` 1 per signature), and the kernel
launches that its runs made.  A replay runs no Python in the wrappers, so
it adds the capture's per-kernel counts through ``kernels.count``; the
warm-up and the capture count nowhere (``kernels.capturing``).  Each run's
launches count on its own thread (``kernels.counting``).

On CPU tensors every kernel wrapper runs its plain version and there is no
graph: the same signature cache and counters hold, and each run walks the
units eagerly (the tests use it that way, with ``Session(device="cpu")``).
"""
from __future__ import annotations

import collections
import functools
import threading
from typing import Any, Dict, List, Optional, Set, Tuple

import torch

from .. import kernels, obs
from ..core.lowering import flatten_units
from ..kernels.spmv import arrange, spmv
from ..kernels.stencil import stencil2d
from ..kernels.stream import StreamKernel
from ..testing import faults
from .base import Executor, plan_device, plan_program
from .reference import as_tensor, eval_node

_TRACES = obs.registry().counter(
    "exec.traces", "captures of a program's unit walk into a CUDA graph "
    "(on the CPU: first walks of a signature), per compiled program "
    "(scope label)")
_DISPATCHES = obs.registry().counter(
    "exec.dispatches", "device dispatches: CUDA-graph replays (on the CPU: "
    "walks), per compiled program (scope label)")
_DONATED_B = obs.registry().counter(
    "exec.donated_bytes", "leaf feed bytes copied into a program's own "
    "leaf buffers (the counterpart of the JAX package's donation)",
    unit="B")
_UNITS = obs.registry().counter(
    "exec.units", "execution units built at compile, by kind "
    "(stream | block | jnp)")


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

def _unit_needed(program, units):
    """Per-unit "read outside this unit" sets over the straight-line unit
    sequence (program outputs always count), and each tensor's reading
    units."""
    outputs = set(program.outputs)
    consumers: Dict[str, List[int]] = {}
    for ui, unit in enumerate(units):
        for o in unit.ops:
            for t in program.nodes[o].inputs:
                consumers.setdefault(t, []).append(ui)
    needed = [{o for o in unit.ops
               if o in outputs or any(c > ui for c in consumers.get(o, ()))}
              for ui, unit in enumerate(units)]
    return needed, consumers


def _leaf_tensors(leaf_names, feeds, device):
    """The leaves as tensors on ``device``, and the run's one float dtype,
    resolved from them (integer leaves, CSR indptr/indices, keep their
    own)."""
    raw: Dict[str, torch.Tensor] = {}
    for leaf in leaf_names:
        if leaf not in feeds:
            raise KeyError(f"feeds missing leaf {leaf!r}")
        raw[leaf] = as_tensor(feeds[leaf], device)
    float_dts = [v.dtype for v in raw.values() if v.is_floating_point()]
    dtype = (functools.reduce(torch.promote_types, float_dts)
             if float_dts else torch.float32)
    return raw, dtype


def _converted(raw, dtype) -> Dict[str, torch.Tensor]:
    """Float leaves in the run's dtype, every leaf contiguous."""
    return {n: (v.to(dtype) if v.is_floating_point() else v).contiguous()
            for n, v in raw.items()}


class _Captured:
    """One signature's graph: the program-owned leaf buffers it reads, the
    output buffers it writes, the launches one replay makes, and the event
    that the last run recorded after copying its outputs out."""

    __slots__ = ("leaves", "graph", "outs", "counts", "done")

    def __init__(self, leaves, graph, outs, counts):
        self.leaves = leaves
        self.graph = graph
        self.outs = outs
        self.counts = {k: v for k, v in counts.items() if v}
        self.done: Optional[torch.cuda.Event] = None


class CudaProgram:
    """One compiled plan: ``feeds -> {output: tensor}`` on its device, one
    graph replay per call on a CUDA device (see the module docstring)."""

    def __init__(self, plan):
        program = plan_program(plan)
        ep = plan.exec_plan
        if ep is None:
            raise ValueError("the cuda backend runs plans lowered by "
                             "Session.lower (they carry an ExecPlan)")
        self.exec_plan = ep
        self.device = torch.device(plan_device(plan))
        units, roll = ep.units, ep.roll
        needed, _ = _unit_needed(program, units)
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
        # counters live on the port's registry under this program's own
        # scope label, as the JAX package's single program keeps them
        self._scope = obs.next_scope("cuda")
        for i in (*pro, *tmpl, *epi):
            _UNITS.inc(backend="cuda", kind=units[i].kind, scope=self._scope)
        self._runs = 0
        self._launches = dict.fromkeys(kernels.LAUNCHES, 0)
        self._stats_lock = threading.Lock()
        self._walked: Set[tuple] = set()          # signatures seen (CPU)
        self._graphs: Dict[tuple, _Captured] = {}
        self._lock = threading.Lock()              # copy-in, replay, copy-out

    @property
    def stats(self) -> Dict[str, Any]:
        """Runs of this program, its captures (``traces``) and replays
        (``dispatches``) from the ``obs`` registry, and the kernel launches
        its runs made, each run's counted on the thread that made it
        (``kernels.counting``), so runs on other threads at the same time
        do not mix in."""
        with self._stats_lock:
            return {
                "runs": self._runs,
                "traces": int(_TRACES.value(backend="cuda",
                                            scope=self._scope)),
                "dispatches": int(_DISPATCHES.value(backend="cuda",
                                                    scope=self._scope)),
                "launches": dict(self._launches)}

    def __call__(self, feeds) -> Dict[str, torch.Tensor]:
        raw, dtype = _leaf_tensors(self.leaf_names, feeds, self.device)
        sig = (dtype, tuple((tuple(v.shape), v.dtype)
                            for v in raw.values()))
        with kernels.counting() as made:
            if self.device.type == "cuda":
                out, traced = self._replay(raw, sig, dtype)
            else:
                out = self._run(_converted(raw, dtype), dtype)
        with self._stats_lock:
            if self.device.type != "cuda":
                traced = sig not in self._walked
                self._walked.add(sig)
            if traced:
                _TRACES.inc(backend="cuda", scope=self._scope)
            _DISPATCHES.inc(backend="cuda", scope=self._scope)
            self._runs += 1
            for k, v in made.items():
                self._launches[k] += v
        return out

    def walk(self, feeds) -> Dict[str, torch.Tensor]:
        """The unit walk that each graph captures, run once eagerly on the
        current stream, outside ``stats``: the body a replay is held
        against (its launches count as any wrapper's do)."""
        raw, dtype = _leaf_tensors(self.leaf_names, feeds, self.device)
        return self._run(_converted(raw, dtype), dtype)

    # -- the graph ------------------------------------------------------
    def _replay(self, raw, sig, dtype):
        """Copy the feeds in, replay the signature's graph (capturing it
        first if it is new), copy the outputs out.  Returns (outputs,
        whether this call captured)."""
        stream = torch.cuda.current_stream(self.device)
        with self._lock:
            cap = self._graphs.get(sig)
            traced = cap is None
            if traced:
                cap = self._graphs[sig] = self._capture(raw, dtype)
            else:
                if cap.done is not None:
                    stream.wait_event(cap.done)
                for name, buf in cap.leaves.items():
                    buf.copy_(raw[name])
            _DONATED_B.inc(sum(b.numel() * b.element_size()
                               for b in cap.leaves.values()),
                           backend="cuda", scope=self._scope)
            cap.graph.replay()
            out = {o: t.clone() for o, t in cap.outs.items()}
            cap.done = torch.cuda.Event()
            cap.done.record(stream)
            for name, n in cap.counts.items():
                kernels.count(name, n)
        return out, traced

    def _capture(self, raw, dtype) -> _Captured:
        leaves = {n: torch.empty(v.shape, device=self.device,
                                 dtype=dtype if v.is_floating_point()
                                 else v.dtype)
                  for n, v in raw.items()}
        for n, buf in leaves.items():
            buf.copy_(raw[n])
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        # the warm-up builds the nvcc library and compiles the Triton
        # passes; like the capture, it runs no counted launch
        with torch.cuda.stream(side), kernels.capturing() as warm:
            self._run(leaves, dtype)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with kernels.capturing() as counts:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outs = self._run(leaves, dtype)
        if counts != warm:
            raise RuntimeError(f"the captured walk launched {counts}, the "
                               f"warm-up {warm}")
        return _Captured(leaves, graph, outs, counts)

    # -- the walk --------------------------------------------------------
    def _run(self, leaves, dtype) -> Dict[str, torch.Tensor]:
        env = dict(leaves)
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
    """Run the plan's units on the hand-written Hopper kernels, one graph
    replay per run."""

    name = "cuda"

    def compile(self, plan) -> CudaProgram:
        # fault-injection site exec.compile@cuda: here as well as in
        # Executor.compiled, as the JAX package's pallas backend has it
        faults.check("exec.compile", backend=self.name)
        return CudaProgram(plan)


class PerUnitCudaExecutor(Executor):
    """The eager executor: one launch sequence per execution unit from
    the host, intermediates freed after their last read.

    The twin of the JAX package's ``pallas-perunit``
    (``repro/exec/pallas.py:1005-1045``): it walks the *unfused* unit
    sequence (``flatten_units``: no cross-pass residency, no rolled loop)
    and captures nothing.  The A/B baseline of the ``cuda`` backend's one
    replay per run, and the eager path for a caller who names it.
    """

    name = "cuda-perunit"

    def compile(self, plan):
        program = plan_program(plan)
        if not plan.group_kernels:
            raise ValueError("the cuda-perunit backend runs plans lowered "
                             "by Session.lower (they carry group kernels)")
        device = torch.device(plan_device(plan))
        units = flatten_units(plan.group_kernels)
        needed, consumers = _unit_needed(program, units)
        calls = [_build_unit(program, units[ui], needed[ui])
                 for ui in range(len(units))]
        scope = obs.next_scope("perunit")
        for unit in units:
            _UNITS.inc(backend=self.name, kind=unit.kind, scope=scope)
        outputs = set(program.outputs)
        # the tensors each unit reads last, freed once it has run
        frees: List[List[str]] = [[] for _ in units]
        for t, uis in consumers.items():
            if t not in outputs:
                frees[max(uis)].append(t)
        leaves = [nd.name for nd in program.leaves()]

        def fn(feeds):
            raw, dtype = _leaf_tensors(leaves, feeds, device)
            env = _converted(raw, dtype)
            for call, dead in zip(calls, frees):
                env.update(call(env))
                for t in dead:
                    env.pop(t, None)
            return {o: env[o] for o in program.outputs}
        return fn
