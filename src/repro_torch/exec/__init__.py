"""`repro_torch.exec` — execution backends for compiled plans.

  ``cuda``       — the plan's units on hand-written Hopper kernels (B1
                   generated Triton passes; B2 CSR SpMV, B3 CSR SpMV with
                   an evict_last L2 hint on a pinned row prefix, and B4
                   stencil in CUDA C++), one CUDA-graph replay per
                   ``run()``; the default backend of ``Session.lower``,
  ``cuda-perunit`` — the same kernels driven eagerly, one unit at a time
                   from the host over the unfused unit sequence (the
                   twin of the JAX package's ``pallas-perunit``),
  ``reference``  — the torch interpreter (op by op, full tensors), the
                   oracle the ``cuda`` backend is held against.

A plan lowered with ``mesh=K`` (K > 1) runs on its mesh: ``cuda`` compiles
it to ``sharded.ShardedProgram``, ``reference`` to
``sharded.ShardedReference``; ``cuda-perunit`` runs the unsharded walk.

Add a backend by subclassing :class:`Executor` and calling
:func:`register_backend`.
"""
from .base import (EXECUTOR_REGISTRY, Executor, get_backend, list_backends,
                   plan_groups, plan_order, plan_program, register_backend)
from .cuda import CudaExecutor, CudaProgram, PerUnitCudaExecutor
from .reference import ReferenceExecutor, evaluate, eval_node, execute_plan

register_backend(ReferenceExecutor)
register_backend(CudaExecutor)
register_backend(PerUnitCudaExecutor)

__all__ = [
    "EXECUTOR_REGISTRY", "Executor", "get_backend", "list_backends",
    "register_backend", "plan_groups", "plan_order", "plan_program",
    "ReferenceExecutor", "CudaExecutor", "CudaProgram",
    "PerUnitCudaExecutor",
    "evaluate", "eval_node", "execute_plan",
]
