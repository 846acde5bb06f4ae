"""The port's launch layer: LLM serving (``serve``) and the solver mesh
that partitioned plans run on (``mesh``)."""
from .mesh import SolverMesh, make_solver_mesh
from .serve import (DecodeStep, ServeBundle, ServeStats, greedy_generate,
                    jit_decode_step, make_decode_fn, make_prefill_fn,
                    make_serving, reset_cache)

__all__ = ["DecodeStep", "ServeBundle", "ServeStats", "SolverMesh",
           "greedy_generate", "jit_decode_step", "make_decode_fn",
           "make_prefill_fn", "make_serving", "make_solver_mesh",
           "reset_cache"]
