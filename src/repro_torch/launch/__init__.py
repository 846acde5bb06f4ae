"""The port's launch layer: LLM serving (``serve``), training
(``train``), the LLM device mesh and its shardings (``mesh``,
``shardings``) and the solver mesh that partitioned plans run on
(``mesh``)."""
from .mesh import (DeviceMesh, SolverMesh, make_local_mesh,
                   make_production_mesh, make_solver_mesh)
from .serve import (DecodeStep, MeshDecodeStep, ServeBundle, ServeStats,
                    greedy_generate, jit_decode_step, make_decode_fn,
                    make_prefill_fn, make_serving, reset_cache)
from .train import (MeshTrainStep, TrainConfig, cross_entropy,
                    jit_train_step, make_loss_fn, make_train_step,
                    optimizer_shardings, train_loop, value_and_grad,
                    zero1_shardings)

__all__ = ["DecodeStep", "DeviceMesh", "MeshDecodeStep", "ServeBundle",
           "ServeStats", "SolverMesh", "make_local_mesh",
           "make_production_mesh", "MeshTrainStep", "jit_train_step",
           "optimizer_shardings", "zero1_shardings",
           "TrainConfig", "cross_entropy", "greedy_generate",
           "jit_decode_step", "make_decode_fn", "make_loss_fn",
           "make_prefill_fn", "make_serving", "make_solver_mesh",
           "make_train_step", "reset_cache", "train_loop", "value_and_grad"]
