"""Mesh-sharded execution of partitioned plans.

The counterpart of ``repro.exec.sharded``.  A
:class:`~repro_torch.core.lowering.ShardedExecPlan` (``partition_plan``)
proves that a co-designed plan splits into K contiguous row blocks; this
module runs the split, as two executables beside the single-device pair:

``ShardedReference``
    The bitwise oracle (``repro/exec/sharded.py:151-259``).  Row-sharded
    tensors are lists of K per-shard blocks, exchanges are exact data
    movement (gather = concatenate in shard order, halo = the neighbour
    blocks' boundary rows), and every op evaluates eagerly through the
    reference's :func:`~repro_torch.exec.reference.eval_node`: per block
    for row-local ops, once on gathered-whole operands for reductions,
    per shard on its CSR entry window for spmv.  Its results equal the
    unsharded reference's bit for bit wherever a row block's product
    equals the rows of the whole product.

``ShardedProgram``
    The mesh path on the kernels (``:329-491``).  The localized plan (rows
    divided by K) builds each stream unit once; every shard runs it on
    its own tensors, on its device slot of a
    :class:`~repro_torch.launch.mesh.SolverMesh`: B2 on the shard's CSR
    window and the gathered ``x``, then B1 in deferred-finalize mode
    (raw reduction sums, no scalar chain).  The program sums the shards'
    raw sums (``psum``, a left fold in shard order), takes the square
    roots of norms and replays the pass's scalar chain through
    ``eval_node`` on every shard.  Contraction right-hand sides and spmv
    vectors are gathered whole (``all_gather``) into ``<name>@g`` aliases
    before the unit that reads them, again in every iteration of a rolled
    loop; stencil sweeps trade one boundary row with each neighbour
    (``ppermute``).  Block and scalar units run inline as torch ops with
    ``eval_node``'s term order (:class:`_InlineUnit`): the JAX package's
    sharded plans skip the whole-grid block kernel too
    (``repro/exec/sharded.py:299-302``), so B4 is not on this path.

    It is a :class:`~repro_torch.exec.cuda.CudaProgram` with another walk:
    on a card the first ``run()`` of a signature walks eagerly, then the
    walk over all K shards is captured into one CUDA graph, and each
    ``run()`` is one replay (``traces`` 1 per signature, ``dispatches ==
    runs``, launches counted per call).  On the CPU every wrapper runs its
    plain version and each run walks.  The shards' reductions reassociate
    (a row block's sum, then the sum over shards), so the program agrees
    with the reference within the reduction-order tolerances of the
    single-device ``cuda`` backend.
"""
from __future__ import annotations

import contextlib
import dataclasses
from types import SimpleNamespace
from typing import Any, Dict, List, Set

import torch

from ..kernels.spmv import spmv_plain
from ..launch.mesh import make_solver_mesh
from .base import plan_device, plan_order, plan_program
from .cuda import CudaProgram, _segments, _StreamUnit
from .reference import as_tensor, eval_node


# --------------------------------------------------------------------------
# shared shard-local rules
# --------------------------------------------------------------------------

def _csr_windows(lay, ip, ix, dv) -> List[tuple]:
    """Each shard's CSR triple: its rows' indptr rebased to 0 and its
    ``pad_entries`` window out of the zero-padded indices and data, from
    the static entry starts of the layout.  Entries past a shard's own
    (the padding, or the next shard's) add to no row: B2 reads only its
    rows' entries, and its plain version drops them."""
    rl = lay.slices[0].rows
    pad = lay.pad_entries
    ixp = torch.cat([ix, ix.new_zeros(pad)])
    dvp = torch.cat([dv, dv.new_zeros(pad)])
    out = []
    for k, e0 in enumerate(lay.entry_starts[:-1]):
        out.append((ip[k * rl:(k + 1) * rl + 1] - e0,
                    ixp[e0:e0 + pad], dvp[e0:e0 + pad]))
    return out


def _stencil_block(node, u, prev_last, next_first, f):
    """One row block of the 5-point stencil: the boundary rows come from
    the neighbour blocks (circular, as ``torch.roll`` wraps); the terms
    add in :func:`eval_node`'s order, so the result is bitwise that of
    the whole grid's rows."""
    down = torch.cat([prev_last, u[:-1]])                  # roll(u, 1, 0)
    up = torch.cat([u[1:], next_first])                    # roll(u, -1, 0)
    out = 0.25 * (down + up + torch.roll(u, 1, 1) + torch.roll(u, -1, 1))
    if f is not None:
        out = out + 0.25 * float(node.param("h2", 1.0)) * f
    return out


# --------------------------------------------------------------------------
# the sharded reference oracle
# --------------------------------------------------------------------------

class ShardedReference:
    """Bitwise sharded oracle: the reference rules over K row blocks, on
    the plan's device (see the module docstring)."""

    def __init__(self, plan):
        self.program = plan_program(plan)
        self.sharded = plan.sharded
        self.order = plan_order(plan)
        self.device = plan_device(plan)
        self.leaf_names = [nd.name for nd in self.program.leaves()]
        self.out_names = list(self.program.outputs)

    def __call__(self, feeds: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        sharded, program = self.sharded, self.program
        shard_set = set(sharded.sharded)
        halo = set(sharded.halo)
        K = sharded.n_shards
        rl = sharded.rows_per_shard

        # env: a replicated value, or a list of K per-shard row blocks
        env: Dict[str, Any] = {}
        for leaf in self.leaf_names:
            if leaf not in feeds:
                raise KeyError(f"feeds missing leaf {leaf!r}")
            v = as_tensor(feeds[leaf], self.device)
            env[leaf] = ([v[k * rl:(k + 1) * rl] for k in range(K)]
                         if leaf in shard_set else v)
        csr_loc = {lay.data: _csr_windows(lay, env[lay.indptr],
                                          env[lay.indices], env[lay.data])
                   for lay in sharded.csr}

        def full(name):
            v = env[name]
            return torch.cat(v) if isinstance(v, list) else v

        def local(name, k):
            v = env[name]
            return v[k] if isinstance(v, list) else v

        for nname in self.order:
            nd = program.nodes[nname]
            ins = nd.inputs
            if nd.op == "spmv":
                x = full(ins[3])
                env[nname] = [spmv_plain(ip, ix, dv, x, rows=rl)
                              for ip, ix, dv in csr_loc[ins[2]]]
            elif nd.op in ("dot", "norm") or (
                    nd.op in ("matmul", "einsum") and nd.shape == ()):
                # reductions run once on gathered-whole operands: the
                # single-device rule itself
                env[nname] = eval_node(nd, [full(t) for t in ins])
            elif nd.op in ("matmul", "einsum"):
                rhs = full(ins[1])
                env[nname] = [eval_node(nd, [local(ins[0], k), rhs])
                              for k in range(K)]
            elif nname in halo:
                u = env[ins[0]]
                env[nname] = [
                    _stencil_block(nd, u[k], u[(k - 1) % K][-1:],
                                   u[(k + 1) % K][:1],
                                   local(ins[1], k) if len(ins) > 1
                                   else None)
                    for k in range(K)]
            elif nname in shard_set:
                env[nname] = [eval_node(nd, [local(t, k) for t in ins])
                              for k in range(K)]
            else:
                env[nname] = eval_node(nd, [env[t] for t in ins])
        return {o: full(o) for o in self.out_names}


# --------------------------------------------------------------------------
# the sharded program
# --------------------------------------------------------------------------

def _local_view(program, sharded):
    """The per-shard view of the expression program: row-sharded names
    take their local shapes, CSR members their window shapes, and
    gathered operands are rewired to ``<name>@g`` alias leaves of the
    global shape (the program fills them with ``all_gather``)."""
    rl = sharded.rows_per_shard
    shard_set = set(sharded.sharded)
    gathered = set(sharded.gathered)
    csr_shapes: Dict[str, tuple] = {}
    for lay in sharded.csr:
        csr_shapes[lay.indptr] = (rl + 1,)
        csr_shapes[lay.indices] = (lay.pad_entries,)
        csr_shapes[lay.data] = (lay.pad_entries,)

    nodes: Dict[str, Any] = {}
    for name, nd in program.nodes.items():
        shape = tuple(nd.shape)
        if name in csr_shapes:
            shape = csr_shapes[name]
        elif name in shard_set:
            shape = (rl,) + shape[1:]
        inputs = tuple(nd.inputs)
        if nd.op in ("matmul", "einsum") and nd.shape != () \
                and inputs[1] in gathered:
            inputs = (inputs[0], inputs[1] + "@g")
        elif nd.op == "spmv" and inputs[3] in gathered:
            inputs = inputs[:3] + (inputs[3] + "@g",)
        if shape != tuple(nd.shape) or inputs != tuple(nd.inputs):
            nd = dataclasses.replace(nd, shape=shape, inputs=inputs)
        nodes[name] = nd
    for g in sharded.gathered:
        nodes[g + "@g"] = dataclasses.replace(
            program.nodes[g], name=g + "@g", op="input", inputs=())
    return SimpleNamespace(nodes=nodes, outputs=tuple(program.outputs))


def _on(device: torch.device):
    """Launches on ``device`` (its card made current) for the block."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


class _InlineUnit:
    """A block or scalar unit run inline on every shard: the reference
    rules per op, stencil sweeps through the halo exchange."""

    def __init__(self, view, ops, needed: Set[str], halo: Set[str], mesh):
        self.nodes = [view.nodes[o] for o in ops]
        produced = {nd.name for nd in self.nodes}
        self.in_names = list(dict.fromkeys(
            t for nd in self.nodes for t in nd.inputs if t not in produced))
        self.out_names = [nd.name for nd in self.nodes if nd.name in needed]
        self.halo = halo
        self.mesh = mesh

    def __call__(self, envs: List[Dict[str, torch.Tensor]]) -> None:
        vals = [{n: env[n] for n in self.in_names} for env in envs]
        for nd in self.nodes:
            if nd.name in self.halo:
                u = [v[nd.inputs[0]] for v in vals]
                prev_last = self.mesh.ppermute([b[-1:] for b in u], 1)
                next_first = self.mesh.ppermute([b[:1] for b in u], -1)
                for k, v in enumerate(vals):
                    with _on(self.mesh.devices[k]):
                        v[nd.name] = _stencil_block(
                            nd, u[k], prev_last[k], next_first[k],
                            v[nd.inputs[1]] if len(nd.inputs) > 1
                            else None)
            else:
                for k, v in enumerate(vals):
                    with _on(self.mesh.devices[k]):
                        v[nd.name] = eval_node(
                            nd, [v[t] for t in nd.inputs])
        for env, v in zip(envs, vals):
            env.update({n: v[n] for n in self.out_names})


class _ShardedStream:
    """A stream unit of the local plan, run by every shard on its own
    tensors (B2 for its spmv ops, then B1 in deferred-finalize mode), its
    raw reduction sums combined over the mesh and its scalar chain
    replayed on every shard."""

    def __init__(self, view, unit, needed: Set[str], mesh):
        self.unit = _StreamUnit(view, unit, needed, defer_finalize=True)
        self.in_names = self.unit.in_names
        self.mesh = mesh

    def __call__(self, envs: List[Dict[str, torch.Tensor]]) -> None:
        outs = []
        for dev, env in zip(self.mesh.devices, envs):
            with _on(dev):
                outs.append(self.unit(env))
        kern = self.unit.pass_
        if kern is None:
            for env, out in zip(envs, outs):
                env.update(out)
            return
        norm = kern.norm_reductions
        for n in kern.red_out:
            total = self.mesh.psum([out[n] for out in outs])
            for out, t in zip(outs, total):
                out[n] = torch.sqrt(t) if n in norm else t
        for dev, env, out in zip(self.mesh.devices, envs, outs):
            env.update(out)
            # the pass's scalar chain (eager and epilogue nodes), replayed
            # on the combined reductions: every shard computes the same
            with _on(dev):
                for nd in kern.finalize_nodes:
                    env[nd.name] = eval_node(nd, [env[t] for t in nd.inputs])


class ShardedProgram(CudaProgram):
    """The mesh path of a partitioned plan: ``feeds -> {output: tensor}``
    on the plan's device, one graph replay per call on a card (see the
    module docstring)."""

    def __init__(self, plan):
        program = plan_program(plan)
        sharded = plan.sharded
        self.sharded = sharded
        self.exec_plan = sharded.local
        self.device = torch.device(plan_device(plan))
        self.mesh = make_solver_mesh(sharded.n_shards, axis=sharded.axis,
                                     device=self.device)
        units, roll = sharded.local.units, sharded.local.roll
        # "read outside the unit" is a property of the global program's
        # dataflow (the @g aliases are the program's own, not dataflow)
        needed, pro, tmpl, epi = _segments(program, units, roll)
        view = _local_view(program, sharded)
        halo = set(sharded.halo)

        def build(i):
            u = units[i]
            if u.kind == "stream":
                return _ShardedStream(view, u, needed[i], self.mesh)
            return _InlineUnit(view, u.ops, needed[i], halo, self.mesh)

        self._pro = [build(i) for i in pro]
        self._tmpl = [build(i) for i in tmpl]
        self._epi = [build(i) for i in epi]
        self.roll = roll
        if roll is not None:
            tmpl_ops = {o for i in tmpl for o in units[i].ops}
            reads = {sl.read for sl in roll.slots if sl.read is not None}
            # an @g alias is gathered again in every iteration from its
            # base value: the base is what the loop reads from outside
            self._tmpl_ext = list(dict.fromkeys(
                base for call in self._tmpl for n in call.in_names
                for base in [n[:-2] if n.endswith("@g") else n]
                if base not in tmpl_ops and base not in reads))
            self._slot_shapes = [view.nodes[sl.update].shape
                                 for sl in roll.slots]
        self._csr_members = {m for lay in sharded.csr
                             for m in (lay.indptr, lay.indices, lay.data)}
        self._init_run_state(program, [units[i] for i in (*pro, *tmpl, *epi)])

    # -- the walk over all shards ---------------------------------------
    def _gather(self, call, envs) -> None:
        """Fill the ``@g`` aliases that ``call`` reads and the shards do
        not hold yet, each the all-gather of its base's blocks."""
        for n in call.in_names:
            if n.endswith("@g") and n not in envs[0]:
                whole = self.mesh.all_gather([env[n[:-2]] for env in envs])
                for env, w in zip(envs, whole):
                    env[n] = w

    def _walk(self, calls, envs) -> None:
        for call in calls:
            self._gather(call, envs)
            call(envs)

    def _run(self, leaves, dtype) -> Dict[str, torch.Tensor]:
        mesh, sharded = self.mesh, self.sharded
        shard_set = set(sharded.sharded)
        envs: List[Dict[str, torch.Tensor]] = [{} for _ in mesh.devices]
        for n, v in leaves.items():
            if n in self._csr_members:
                continue
            parts = (mesh.split(v) if n in shard_set
                     else [v.to(dev) for dev in mesh.devices])
            for env, p in zip(envs, parts):
                env[n] = p
        for lay in sharded.csr:
            windows = _csr_windows(lay, leaves[lay.indptr],
                                   leaves[lay.indices], leaves[lay.data])
            for env, dev, triple in zip(envs, mesh.devices, windows):
                for name, t in zip((lay.indptr, lay.indices, lay.data),
                                   triple):
                    env[name] = t.to(dev)
        self._walk(self._pro, envs)
        if self.roll is not None:
            slots = self.roll.slots
            base = [{n: env[n] for n in self._tmpl_ext} for env in envs]
            carry = [[env[sl.init] if sl.init is not None
                      else torch.zeros(shape, dtype=dtype, device=dev)
                      for sl, shape in zip(slots, self._slot_shapes)]
                     for env, dev in zip(envs, mesh.devices)]
            for _ in range(self.roll.n_iters):
                envs_l = [dict(b) for b in base]
                for env_l, c in zip(envs_l, carry):
                    for sl, v in zip(slots, c):
                        if sl.read is not None:
                            env_l[sl.read] = v
                self._walk(self._tmpl, envs_l)
                carry = [[env_l[sl.update] for sl in slots]
                         for env_l in envs_l]
            for env, c in zip(envs, carry):
                for sl, v in zip(slots, c):
                    env[sl.final] = v
        self._walk(self._epi, envs)
        return {o: mesh.concat([env[o] for env in envs]) if o in shard_set
                else envs[0][o] for o in self.out_names}
