"""CELLO core for the PyTorch port: the planning layer, copied.

The same modules as ``repro.core`` (graph IR, reuse analysis, hybrid
buffer simulator, cost model, the co-design search, the LLM layer graphs
and execution planning, and the LLM plan policy).  They are pure Python; the port keeps its own copy
because ``repro.core`` loads jax on import.  ``V5E`` stays the default
hardware model so that plans made here equal the JAX package's.
"""
from .graph import GraphBuilder, OpGraph, OpNode, TensorKind, TensorSpec
from .reuse import ReuseAnalysis, TensorReuse, analyze
from .buffer import BufferConfig, TrafficReport, simulate, sequential_groups
from .costmodel import HardwareModel, Metrics, V5E, evaluate
from .schedule import (CoDesignResult, EvaluatedSchedule, Schedule,
                       build_groups, choose_pins)
from .search import (DEFAULT_SPLITS, SearchStrategy, get_strategy,
                     register_strategy, run_codesign)
from .lowering import (CarrySlot, ExecPlan, ExecUnit, GroupKernel,
                       RolledLoop, StreamPass, decode_graph,
                       detect_rolled_loop, flatten_units, fuse_units,
                       layer_graph, plan_execution, select_group_kernels)
from .policy import CelloPlan, default_plan, lower_codesign

__all__ = [
    "GraphBuilder", "OpGraph", "OpNode", "TensorKind", "TensorSpec",
    "ReuseAnalysis", "TensorReuse", "analyze",
    "BufferConfig", "TrafficReport", "simulate", "sequential_groups",
    "HardwareModel", "Metrics", "V5E", "evaluate",
    "CoDesignResult", "EvaluatedSchedule", "Schedule",
    "build_groups", "choose_pins",
    "DEFAULT_SPLITS", "SearchStrategy", "get_strategy", "register_strategy",
    "run_codesign",
    "CarrySlot", "ExecPlan", "ExecUnit", "GroupKernel", "RolledLoop",
    "StreamPass", "detect_rolled_loop", "flatten_units", "fuse_units",
    "plan_execution", "select_group_kernels", "layer_graph",
    "decode_graph", "CelloPlan", "default_plan", "lower_codesign",
]
