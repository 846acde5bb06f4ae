"""The port's launch layer: LLM serving (``serve``), training
(``train``) and the solver mesh that partitioned plans run on (``mesh``)."""
from .mesh import SolverMesh, make_solver_mesh
from .serve import (DecodeStep, ServeBundle, ServeStats, greedy_generate,
                    jit_decode_step, make_decode_fn, make_prefill_fn,
                    make_serving, reset_cache)
from .train import (TrainConfig, cross_entropy, make_loss_fn,
                    make_train_step, train_loop, value_and_grad)

__all__ = ["DecodeStep", "ServeBundle", "ServeStats", "SolverMesh",
           "TrainConfig", "cross_entropy", "greedy_generate",
           "jit_decode_step", "make_decode_fn", "make_loss_fn",
           "make_prefill_fn", "make_serving", "make_solver_mesh",
           "make_train_step", "reset_cache", "train_loop", "value_and_grad"]
