"""`repro_torch.api` — the staged front-end of the port::

    from repro_torch.api import Session

    plan = (Session()                                 # device="cuda"
            .trace(workload="cg_sparse", n=1 << 20, iters=64)
            .analyze()
            .codesign()
            .lower())                                 # backend="cuda"
    out = plan.run()

Execution backends follow the registry pattern of ``repro.exec``:
``CompiledPlan.run(backend="cuda" | "reference")``.  ``codesign`` results
are kept in the port's own disk cache (``api.cache``).
"""
from ..core.costmodel import HardwareModel, V5E
from ..core.search import (DEFAULT_SPLITS, SearchStrategy, get_strategy,
                           register_strategy, run_codesign)
from ..exec import (EXECUTOR_REGISTRY, Executor, get_backend, list_backends,
                    register_backend)
from .artifacts import (AnalyzedGraph, CelloPlan, CoDesigned, CompiledPlan,
                        TracedGraph)
from .cache import CodesignCache, frontend_fingerprint, graph_fingerprint
from .config import CodesignConfig, ExecConfig, ServeConfig
from .session import Session, resolve_device

__all__ = [
    "Session", "resolve_device",
    "CodesignConfig", "ExecConfig", "ServeConfig",
    "TracedGraph", "AnalyzedGraph", "CoDesigned", "CompiledPlan",
    "CelloPlan", "HardwareModel", "V5E",
    "CodesignCache", "frontend_fingerprint", "graph_fingerprint",
    "SearchStrategy", "DEFAULT_SPLITS", "get_strategy", "register_strategy",
    "run_codesign",
    "Executor", "EXECUTOR_REGISTRY", "get_backend", "list_backends",
    "register_backend",
]
