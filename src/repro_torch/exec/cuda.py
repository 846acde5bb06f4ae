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

:class:`CudaLaneProgram` is the lane-batched program that serving runs
(``Executor.compile_batched``, the counterpart of the JAX package's vmap of
its single program): one walk answers L requests.  A node carries a lane
axis when one of its inputs does, starting from the input leaves
(:func:`lane_names`); operator leaves, and any node computed from them
alone, are the single-request tensors and run once.  Every tensor with
lanes is lane-major (the request first, as the feeds come), so no unit
converts a layout: stream units run B1's lane form (B2's for their spmv
ops, B3's for those that run on B3 unbatched), block units B4's, ``jnp``
units ``torch.func.vmap`` of the reference rules.  Its graphs are one per
(lanes, dtype, leaf shapes).  A program built with the operator bound
(``shared``: tensors on its device, as the serving router holds a
bucket's) has its graphs read those tensors in place, and every run must
pass them; an unbound program copies the operator into its own buffers,
one set per dtype shared by its graphs, on every run.

A plan lowered with ``mesh=K`` (K > 1) compiles to
``exec.sharded.ShardedProgram``: this program's capture, replay and
``stats`` over a walk of K shards.
"""
from __future__ import annotations

import collections
import functools
import threading
from typing import Any, Dict, List, Optional, Set, Tuple

import torch

from .. import kernels, obs
from ..core.lowering import flatten_units
from ..kernels.spmv import arrange, spmv, spmv_lanes, spmv_sliced_lanes
from ..kernels.stencil import stencil2d, stencil2d_lanes
from ..kernels.stream import LaneStreamKernel, StreamKernel
from ..testing import faults
from .base import Executor, plan_device, plan_program, plan_shards
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


def lane_names(program) -> Set[str]:
    """The tensors that carry a lane axis in a lane-batched run: every
    leaf that is not an operator, and every node with such an input.  A
    node whose inputs are operators or lane-independent is computed once
    (what vmap did on the TPU)."""
    leaves = {nd.name for nd in program.leaves()}
    out: Set[str] = set()
    for name, nd in program.nodes.items():      # in build (topological) order
        if (nd.op != "operator" if name in leaves
                else any(t in out for t in nd.inputs)):
            out.add(name)
    return out


class _Pass:
    """A B1 pass over ``nodes``; with ``lanes``, its lane-independent nodes
    run once as a single-request pass and the rest as B1's lane form."""

    def __init__(self, nodes, shapes, needed: Set[str], rows: int,
                 lanes: Optional[Set[str]]):
        once = [nd for nd in nodes if lanes is None or nd.name not in lanes]
        each = [nd for nd in nodes if lanes is not None and nd.name in lanes]
        reads = {t for nd in each for t in nd.inputs}
        self.once = (StreamKernel(once, shapes, needed | reads, rows)
                     if once else None)
        self.each = (LaneStreamKernel(each, shapes, needed, rows, lanes)
                     if each else None)
        produced = {nd.name for nd in nodes}
        self.in_names = list(dict.fromkeys(
            t for nd in nodes for t in nd.inputs if t not in produced))

    def __call__(self, env) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        if self.once is not None:
            out.update(self.once(env))
        if self.each is not None:
            out.update(self.each(collections.ChainMap(out, env)))
        return out


class _StreamUnit:
    """A ``stream`` unit: B3 or B2 launches for its spmv ops, then one B1
    pass.  With ``lanes``, its lane form: B3's or B2's lane form for an
    spmv op whose vector carries lanes (B3's where the op runs on B3
    unbatched), B1's for the pass (see :class:`_Pass`).
    With ``defer_finalize``, a mesh shard's unit: B1 in its
    deferred-finalize mode (``exec.sharded``)."""

    def __init__(self, program, unit, needed: Set[str],
                 lanes: Optional[Set[str]] = None, *,
                 defer_finalize: bool = False):
        sp = unit.sp
        nodes = [program.nodes[o] for o in sp.ops]
        self.spmv_nodes = [nd for nd in nodes if nd.op == "spmv"]
        self.prefix = spmv_prefixes(program, sp)
        self.lanes = lanes
        if lanes is not None:
            for nd in self.spmv_nodes:
                if any(t in lanes for t in nd.inputs[:3]):
                    raise NotImplementedError(
                        f"{nd.name}: a sparse operand per request has no "
                        "lane form; the operand must be an operator leaf")
        rest = [nd for nd in nodes if nd.op != "spmv"]
        shapes = {n: program.nodes[n].shape
                  for nd in nodes for n in (*nd.inputs, nd.name)}
        if rest and lanes is None:
            self.pass_ = StreamKernel(rest, shapes, needed, sp.rows,
                                      defer_finalize=defer_finalize)
        else:
            self.pass_ = (_Pass(rest, shapes, needed, sp.rows, lanes)
                          if rest else None)
        self.spmv_out = [nd.name for nd in self.spmv_nodes
                         if nd.name in needed]
        produced = {nd.name for nd in nodes}
        self.in_names = list(dict.fromkeys(
            t for nd in nodes for t in nd.inputs if t not in produced))

    def _spmv(self, nd, env):
        operands = [env[t] for t in nd.inputs]
        prefix = self.prefix[nd.name]
        if self.lanes is not None and nd.name in self.lanes:
            return (spmv_lanes(*operands, rows=nd.shape[0]) if prefix is None
                    else spmv_sliced_lanes(*operands, rows=nd.shape[0],
                                           prefix_rows=prefix))
        return spmv(*operands, rows=nd.shape[0], prefix_rows=prefix)

    def __call__(self, env: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        vals = {nd.name: self._spmv(nd, env) for nd in self.spmv_nodes}
        out = {n: vals[n] for n in self.spmv_out}
        if self.pass_ is not None:
            out.update(self.pass_(collections.ChainMap(vals, env)))
        return out


class _BlockUnit:
    """A ``block`` unit: B4 per stencil op, B1 over flattened arrays per run
    of elementwise ops.  Stencil results read only inside the unit live in
    scratch buffers that are reused once dead (two suffice for a chain).
    With ``lanes``, its lane form: B4's and B1's."""

    def __init__(self, program, unit, needed: Set[str],
                 lanes: Optional[Set[str]] = None):
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
                                                 rows) if lanes is None
                          else _Pass(list(run), shapes, keep, rows, lanes)))
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
        self.shapes = {n: program.nodes[n].shape
                       for nd in nodes for n in (*nd.inputs, nd.name)}
        self.lanes = lanes
        self.lane_in = [t for t in self.in_names
                        if lanes is not None and t in lanes]

    def __call__(self, env: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        vals: Dict[str, torch.Tensor] = {}
        scratch: Dict[str, torch.Tensor] = {}    # stencil outputs it owns
        free: List[torch.Tensor] = []
        n = int(env[self.lane_in[0]].shape[0]) if self.lane_in else None

        def get(t):
            return vals[t] if t in vals else env[t]

        def lead(t):          # a tensor's lane axis, if it has one
            return (n,) if n is not None and t in self.lanes else ()

        for si, (kind, obj) in enumerate(self.steps):
            if kind == "stencil":
                nd = obj
                out = None
                if nd.name not in self.needed and free:
                    out = free.pop()
                u = get(nd.inputs[0])
                f = get(nd.inputs[1]) if len(nd.inputs) > 1 else None
                vals[nd.name] = (
                    stencil2d_lanes(u, f, nd.param("h2", 1.0), out=out,
                                    lanes=n) if lead(nd.name)
                    else stencil2d(u, f, nd.param("h2", 1.0), out=out))
                if nd.name not in self.needed:
                    scratch[nd.name] = vals[nd.name]
            else:
                flat = {t: get(t).reshape(*lead(t), -1)
                        if self.shapes[t] != () else get(t)
                        for t in obj.in_names}
                for name, v in obj(flat).items():
                    vals[name] = v.reshape(*lead(name), *self.shapes[name])
            for t, buf in list(scratch.items()):
                if self.last_read.get(t, -1) <= si:
                    free.append(buf)
                    del scratch[t]
        return {n: vals[n] for n in self.out_names}


class _TorchUnit:
    """A ``jnp`` unit: the reference rules as plain torch ops.  With
    ``lanes``, its lane-independent nodes run once and the others under
    ``torch.func.vmap`` over their lane inputs."""

    def __init__(self, program, unit, needed: Set[str],
                 lanes: Optional[Set[str]] = None):
        self.nodes = [program.nodes[o] for o in unit.ops]
        produced = {nd.name for nd in self.nodes}
        self.in_names = list(dict.fromkeys(
            t for nd in self.nodes for t in nd.inputs if t not in produced))
        self.out_names = [nd.name for nd in self.nodes if nd.name in needed]
        lanes = lanes or set()
        self.once = [nd for nd in self.nodes if nd.name not in lanes]
        self.each = [nd for nd in self.nodes if nd.name in lanes]
        self.lane_in = [t for t in self.in_names if t in lanes]

    def __call__(self, env: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        vals: Dict[str, torch.Tensor] = {}
        for nd in self.once:
            vals[nd.name] = eval_node(
                nd, [vals[t] if t in vals else env[t] for t in nd.inputs])
        if self.each:
            names = [nd.name for nd in self.each]

            def lane(*xs):
                lv = dict(zip(self.lane_in, xs))
                for nd in self.each:
                    lv[nd.name] = eval_node(nd, [
                        lv[t] if t in lv else vals[t] if t in vals
                        else env[t] for t in nd.inputs])
                return tuple(lv[n] for n in names)

            vals.update(zip(names, torch.func.vmap(lane)(
                *(env[t] for t in self.lane_in))))
        return {n: vals[n] for n in self.out_names}


def _build_unit(program, unit, needed: Set[str],
                lanes: Optional[Set[str]] = None):
    """A unit's callable; its lane form when ``lanes`` names a tensor that
    it computes (a unit of lane-independent ops runs once either way)."""
    if lanes is not None and not lanes & set(unit.ops):
        lanes = None
    if unit.kind == "stream":
        return _StreamUnit(program, unit, needed, lanes)
    if unit.kind == "block":
        return _BlockUnit(program, unit, needed, lanes)
    return _TorchUnit(program, unit, needed, lanes)


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


def _segments(program, units, roll):
    """Per-unit needed sets, with the loop-carried values added (they must
    leave their units even when the straight-line view says nothing later
    reads them), and the unit indices of the prologue, the rolled loop's
    template and the epilogue."""
    needed, _ = _unit_needed(program, units)
    if roll is None:
        return needed, range(len(units)), (), ()
    updates = {sl.update for sl in roll.slots}
    inits = {sl.init for sl in roll.slots if sl.init is not None}
    for ui in range(roll.first, roll.first + roll.per_iter):
        needed[ui] = needed[ui] | (updates & set(units[ui].ops))
    for ui in range(roll.first):
        needed[ui] = needed[ui] | (inits & set(units[ui].ops))
    return (needed, range(roll.first),
            range(roll.first, roll.first + roll.per_iter),
            range(roll.stop, len(units)))


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
    """One signature's graph: the program-owned leaf buffers it reads (the
    lane program's operator excepted: bound, or in buffers per dtype), the
    output buffers it writes and the launches one replay makes."""

    __slots__ = ("leaves", "graph", "outs", "counts")

    def __init__(self, leaves, graph, outs, counts):
        self.leaves = leaves
        self.graph = graph
        self.outs = outs
        self.counts = {k: v for k, v in counts.items() if v}


class CudaProgram:
    """One compiled plan: ``feeds -> {output: tensor}`` on its device, one
    graph replay per call on a CUDA device (see the module docstring)."""

    def __init__(self, plan, lanes: Optional[Set[str]] = None):
        program = plan_program(plan)
        ep = plan.exec_plan
        if ep is None:
            raise ValueError("the cuda backend runs plans lowered by "
                             "Session.lower (they carry an ExecPlan)")
        self.exec_plan = ep
        self.device = torch.device(plan_device(plan))
        self.lanes = lanes
        units, roll = ep.units, ep.roll
        needed, pro, tmpl, epi = _segments(program, units, roll)

        def build(i):
            return _build_unit(program, units[i], needed[i], lanes)

        self._pro = [build(i) for i in pro]
        self._tmpl = [build(i) for i in tmpl]
        self._epi = [build(i) for i in epi]
        self.roll = roll
        if roll is not None:
            tmpl_ops = {o for i in tmpl for o in units[i].ops}
            reads = {sl.read for sl in roll.slots if sl.read is not None}
            self._tmpl_ext = list(dict.fromkeys(
                n for call in self._tmpl for n in call.in_names
                if n not in tmpl_ops and n not in reads))
            self._slot_shapes = [program.nodes[sl.update].shape
                                 for sl in roll.slots]
        self._init_run_state(program, [units[i] for i in (*pro, *tmpl, *epi)])

    def _init_run_state(self, program, units) -> None:
        """The run's state: leaves and outputs, the counters under
        this program's own ``obs`` scope, the graphs and their lock."""
        self.leaf_names = [nd.name for nd in program.leaves()]
        self.out_names = list(program.outputs)
        self.out_shapes = {o: program.nodes[o].shape for o in self.out_names}
        # counters live on the port's registry under this program's own
        # scope label, as the JAX package's single program keeps them
        self._scope = obs.next_scope("cuda")
        for unit in units:
            _UNITS.inc(backend="cuda", kind=unit.kind, scope=self._scope)
        self._runs = 0
        self._launches = dict.fromkeys(kernels.LAUNCHES, 0)
        self._stats_lock = threading.Lock()
        self._walked: Set[tuple] = set()          # signatures seen (CPU)
        self._graphs: Dict[tuple, _Captured] = {}
        self._lock = threading.Lock()              # copy-in, replay, copy-out
        # recorded by the last run after its copy-out; the next run's
        # stream waits on it before touching the program's buffers
        self._done: Optional[torch.cuda.Event] = None

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
    def _fill(self, raw, dtype, cap: Optional[_Captured]):
        """The leaf buffers the signature's graph reads, holding this run's
        feeds (made when the graph is new), and the bytes copied."""
        leaves = dict(cap.leaves) if cap is not None else {
            n: torch.empty(v.shape, device=self.device,
                           dtype=dtype if v.is_floating_point() else v.dtype)
            for n, v in raw.items()}
        for n in raw:
            leaves[n].copy_(raw[n])
        return leaves, sum(leaves[n].numel() * leaves[n].element_size()
                           for n in raw)

    def _replay(self, raw, sig, dtype):
        """Copy the feeds in, replay the signature's graph (capturing it
        first if it is new), copy the outputs out.  Returns (outputs,
        whether this call captured)."""
        stream = torch.cuda.current_stream(self.device)
        with self._lock:
            if self._done is not None:
                stream.wait_event(self._done)
            cap = self._graphs.get(sig)
            traced = cap is None
            leaves, copied = self._fill(raw, dtype, cap)
            if traced:
                cap = self._graphs[sig] = self._capture(leaves, dtype)
            _DONATED_B.inc(copied, backend="cuda", scope=self._scope)
            cap.graph.replay()
            out = {o: t.clone() for o, t in cap.outs.items()}
            self._done = torch.cuda.Event()
            self._done.record(stream)
            for name, n in cap.counts.items():
                kernels.count(name, n)
        return out, traced

    def _capture(self, leaves, dtype) -> _Captured:
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
    def _n_lanes(self, leaves) -> Optional[int]:
        return None

    def _run(self, leaves, dtype) -> Dict[str, torch.Tensor]:
        env = dict(leaves)
        n_lanes = self._n_lanes(leaves)

        def lead(name):       # a tensor's lane axis, if it has one
            return ((n_lanes,) if n_lanes is not None and name in self.lanes
                    else ())

        for call in self._pro:
            env.update(call(env))
        if self.roll is not None:
            slots = self.roll.slots
            base = {n: env[n] for n in self._tmpl_ext}
            # output-only slots (init=None) seed with zeros: their carry-in
            # is never read, only their final generation leaves the loop
            carry = [env[sl.init] if sl.init is not None
                     else torch.zeros((*lead(sl.update), *shape),
                                      dtype=dtype, device=self.device)
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
        # an output without lanes is every lane's
        return {o: env[o] if n_lanes is None or lead(o)
                else env[o].expand(n_lanes, *self.out_shapes[o])
                for o in self.out_names}


class CudaLaneProgram(CudaProgram):
    """The lane-batched program that serving runs: ``(shared, batched) ->
    {output: (L, ...)}``, ``shared`` the operator leaves at their traced
    shape and ``batched`` the input leaves with a leading lane axis, one
    graph replay per call on a CUDA device (see the module docstring).

    ``shared``, when given, binds the operator: contiguous tensors on the
    plan's device, in the dtype of every run, that the graphs read in
    place, so a write to them shows in the next run; each call must pass
    these very tensors."""

    def __init__(self, plan, shared: Optional[Dict[str, torch.Tensor]] = None):
        program = plan_program(plan)
        super().__init__(plan, lanes=lane_names(program))
        self.shared_leaves = [n for n in self.leaf_names
                              if n not in self.lanes]
        self.batched_leaves = [n for n in self.leaf_names if n in self.lanes]
        self._bound: Optional[Dict[str, torch.Tensor]] = None
        if shared is not None:
            self._bound = {n: shared[n] for n in self.shared_leaves}
            for n, t in self._bound.items():
                if (not isinstance(t, torch.Tensor)
                        or t.device.type != self.device.type
                        or self.device.index not in (None, t.device.index)
                        or not t.is_contiguous()):
                    raise ValueError(f"bound operator leaf {n!r} must be a "
                                     f"contiguous tensor on {self.device}")
        # an unbound program's operator buffers, one set per dtype for
        # every lane count, refilled on every run
        self._shared: Dict[torch.dtype, Dict[str, torch.Tensor]] = {}

    def __call__(self, shared, batched) -> Dict[str, torch.Tensor]:
        if self._bound is not None:
            for n, t in self._bound.items():
                if shared.get(n) is not t:
                    raise ValueError(f"operator leaf {n!r}: this program "
                                     "reads the tensor bound at its build; "
                                     "pass that tensor")
        return super().__call__({**shared, **batched})

    def _n_lanes(self, leaves) -> int:
        counts = {int(leaves[n].shape[0]) for n in self.batched_leaves}
        if len(counts) != 1:
            raise ValueError(f"batched leaves disagree on the lane count: "
                             f"{sorted(counts)}")
        (n,) = counts
        return n

    def _fill(self, raw, dtype, cap):
        leaves, copied = super()._fill(
            {n: raw[n] for n in self.batched_leaves}, dtype, cap)
        if self._bound is not None:
            for n, t in self._bound.items():
                if t.is_floating_point() and t.dtype != dtype:
                    raise ValueError(f"bound operator leaf {n!r} is "
                                     f"{t.dtype}, the run {dtype}")
            return {**leaves, **self._bound}, copied
        held = self._shared.get(dtype)
        if held is None:
            held = self._shared[dtype] = {
                n: torch.empty(raw[n].shape, device=self.device,
                               dtype=(dtype if raw[n].is_floating_point()
                                      else raw[n].dtype))
                for n in self.shared_leaves}
        for n in self.shared_leaves:
            held[n].copy_(raw[n])
            copied += held[n].numel() * held[n].element_size()
        return {**leaves, **held}, copied


class CudaExecutor(Executor):
    """Run the plan's units on the hand-written Hopper kernels, one graph
    replay per run."""

    name = "cuda"

    def compile(self, plan) -> CudaProgram:
        """The plan's program; a plan lowered with ``mesh=K`` (K > 1) runs
        on the mesh (``exec.sharded.ShardedProgram``)."""
        # fault-injection site exec.compile@cuda: here as well as in
        # Executor.compiled, as the JAX package's pallas backend has it
        faults.check("exec.compile", backend=self.name)
        if plan_shards(plan) > 1:
            from .sharded import ShardedProgram
            return ShardedProgram(plan)
        return CudaProgram(plan)

    def compile_batched(self, plan, shared=None) -> CudaLaneProgram:
        """The lane-batched program: B1-B4 in their lane forms, one
        graph replay per (lanes, dtype, leaf shapes) signature, its graphs
        reading the operator ``shared`` binds in place.  A mesh-sharded
        plan has none."""
        faults.check("exec.compile", backend=self.name)
        if plan_shards(plan) > 1:
            raise ValueError(
                "mesh-sharded plans have no lane-batched program; "
                "serve/batch them unsharded or run() them directly")
        return CudaLaneProgram(plan, shared)


class PerUnitCudaExecutor(Executor):
    """The eager executor: one launch sequence per execution unit from
    the host, intermediates freed after their last read.

    The twin of the JAX package's ``pallas-perunit``
    (``repro/exec/pallas.py:1005-1045``): it walks the *unfused* unit
    sequence (``flatten_units``: no cross-pass residency, no rolled loop)
    and captures nothing; a mesh-sharded plan runs this unsharded walk too,
    as on ``pallas-perunit``.  The A/B baseline of the ``cuda`` backend's one
    replay per run, and the eager path for a caller who names it; its
    batched form walks the same units in their lane forms.
    """

    name = "cuda-perunit"

    def compile(self, plan):
        return self._compile(plan, None)

    def compile_batched(self, plan, shared=None):
        faults.check("exec.compile", backend=self.name)
        fn = self._compile(plan, lane_names(plan_program(plan)))
        return lambda shared, batched: fn({**shared, **batched})

    def _compile(self, plan, lanes: Optional[Set[str]]):
        program = plan_program(plan)
        if not plan.group_kernels:
            raise ValueError("the cuda-perunit backend runs plans lowered "
                             "by Session.lower (they carry group kernels)")
        device = torch.device(plan_device(plan))
        units = flatten_units(plan.group_kernels)
        needed, consumers = _unit_needed(program, units)
        calls = [_build_unit(program, units[ui], needed[ui], lanes)
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
        first_lane_leaf = [n for n in leaves if lanes and n in lanes][:1]

        def fn(feeds):
            raw, dtype = _leaf_tensors(leaves, feeds, device)
            env = _converted(raw, dtype)
            for call, dead in zip(calls, frees):
                env.update(call(env))
                for t in dead:
                    env.pop(t, None)
            if not first_lane_leaf:
                return {o: env[o] for o in program.outputs}
            n = int(raw[first_lane_leaf[0]].shape[0])
            return {o: env[o] if o in lanes
                    else env[o].expand(n, *program.nodes[o].shape)
                    for o in program.outputs}
        return fn
