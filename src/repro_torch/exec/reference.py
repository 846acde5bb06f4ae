"""The ``reference`` execution backend: a torch interpreter.

The counterpart of ``repro.exec.reference`` and the oracle the ``cuda``
backend is held against.  It executes one op at a time at full-tensor
granularity; :func:`eval_node` defines the semantics of every expression
op.  Ops are pure, so replaying a co-designed schedule order through the
same rules matches natural-order evaluation bit for bit.

The rules follow the JAX reference's operand and add order: ``stencil2d``
sums its four rolled neighbours left to right, and ``spmv`` adds each
row's products in ascending entry order (``index_add_`` on the CPU; on a
CUDA device ``index_add_`` adds through atomics in no fixed order, so the
oracle is exact there only up to reassociation).  Those two rules are the
plain versions of the B2 and B4 kernels (``repro_torch.kernels``).

A plan lowered with ``mesh=K`` (K > 1) compiles to
``exec.sharded.ShardedReference``: these rules over K row blocks.

Its batched form (``compile_batched``, for serving) is
:meth:`Executor.compile_batched`'s default: the interpreter once a lane,
on the plan's device (the exact oracle a server falls back to).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..kernels.spmv import spmv_plain
from ..kernels.stencil import stencil2d_plain
from ..testing import faults
from .base import (Executor, plan_device, plan_order, plan_program,
                   plan_shards)


def eval_node(node, ins: List[Any]):
    """Reference rule for one expression op (``ins`` in operand order)."""
    op = node.op
    if op == "matmul":
        return ins[0] @ ins[1]
    if op == "einsum":
        return torch.einsum(node.param("spec"), *ins)
    if op == "dot":
        return torch.dot(ins[0], ins[1])
    if op == "norm":
        v = ins[0].reshape(-1)
        return torch.sqrt(torch.dot(v, v))
    if op == "add":
        return ins[0] + ins[1]
    if op == "sub":
        return ins[0] - ins[1]
    if op == "mul":
        return ins[0] * ins[1]
    if op == "div":
        return ins[0] / ins[1]
    if op == "neg":
        return -ins[0]
    if op == "axpy":
        return ins[0] * ins[1] + ins[2]
    if op == "stencil2d":
        return stencil2d_plain(ins[0], ins[1] if len(ins) > 1 else None,
                               node.param("h2", 1.0))
    if op == "gather":
        return ins[0].index_select(0, ins[1].long())
    if op == "spmv":
        return spmv_plain(*ins, rows=node.shape[0])
    raise NotImplementedError(f"reference rule missing for op {op!r}")


def as_tensor(v, device) -> torch.Tensor:
    """A feed value as a tensor on ``device``: integer leaves become
    int32, float dtypes are kept.  On the CPU a writable numpy array is
    shared, not copied (no backend writes into its feeds)."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    a = np.asarray(v)
    if a.dtype.kind in "iu":
        a = a.astype(np.int32, order="C")
    elif not (a.flags.writeable and a.flags.c_contiguous):
        a = a.copy(order="C")          # torch may neither share nor stride it
    return torch.from_numpy(a).to(device)


def execute_plan(program, *, order: Optional[Sequence[str]] = None,
                 feeds: Optional[Dict[str, Any]] = None,
                 seed: int = 0, return_all: bool = False,
                 device=None) -> Dict[str, torch.Tensor]:
    """Execute the program's ops in ``order`` (default: build order).

    ``order`` is the flattened schedule from a co-designed plan; it must be
    a topological permutation of the program's ops — validated here, since
    a schedule that reads an unproduced tensor is a lowering bug.  Feeds are
    moved to ``device``; with ``device=None`` tensor feeds stay where they
    are and numpy feeds go to the CPU.
    """
    vals: Dict[str, Any] = {}
    op_names = program.schedulable_order()
    order = list(order) if order is not None else op_names
    if sorted(order) != sorted(op_names):
        raise ValueError(f"order is not a permutation of {program.name!r} "
                         "ops")
    if feeds is None:
        from ..frontends.reference import make_feeds
        feeds = make_feeds(program, seed)
    for nd in program.leaves():
        if nd.name not in feeds:
            raise KeyError(f"feeds missing leaf {nd.name!r}")
        v = feeds[nd.name]
        vals[nd.name] = (v if device is None and isinstance(v, torch.Tensor)
                         else as_tensor(v, device or "cpu"))
    # free dead intermediates as execution passes their last consumer
    last_use: Dict[str, int] = {}
    for step, nname in enumerate(order):
        for t in program.nodes[nname].inputs:
            last_use[t] = step
    keep = set(program.outputs) if not return_all else set(vals) | set(order)
    for step, nname in enumerate(order):
        node = program.nodes[nname]
        missing = [i for i in node.inputs if i not in vals]
        if missing:
            raise ValueError(f"schedule order not topological: {nname} "
                             f"reads unproduced {missing}")
        vals[nname] = eval_node(node, [vals[i] for i in node.inputs])
        if not return_all:
            for t in set(node.inputs):
                if last_use[t] == step and t not in keep:
                    del vals[t]
    if return_all:
        return vals
    return {o: vals[o] for o in program.outputs}


def evaluate(program, feeds: Optional[Dict[str, Any]] = None, *,
             seed: int = 0, return_all: bool = False,
             device=None) -> Dict[str, torch.Tensor]:
    """Reference evaluation in the program's natural (build) order."""
    return execute_plan(program, order=None, feeds=feeds, seed=seed,
                        return_all=return_all, device=device)


class ReferenceExecutor(Executor):
    """Replay the co-designed schedule order through the interpreter."""

    name = "reference"

    def compile(self, plan):
        # fault-injection site: exec.compile@reference (also here, as in
        # the JAX package, for callers that compile without
        # Executor.compiled)
        faults.check("exec.compile", backend=self.name)
        if plan_shards(plan) > 1:
            # a mesh-partitioned plan: the same rules over K row blocks,
            # reductions on gathered-whole operands (bitwise the same)
            from .sharded import ShardedReference
            return ShardedReference(plan)
        program = plan_program(plan)
        order = plan_order(plan)
        device = plan_device(plan)

        def fn(feeds):
            return execute_plan(program, order=order, feeds=feeds,
                                device=device)
        return fn
