"""Typed configuration objects for the port's public API.

The typed configs of ``repro.api.config``: :class:`CodesignConfig` holds
the schedule × buffer search knobs of ``Session.codesign``,
:class:`ExecConfig` the execution knobs of ``Session.lower`` /
``CompiledPlan.run``, :class:`ServeConfig` the knobs of
``repro_torch.serve.Server``.  The port takes these only; the JAX
package's deprecated per-keyword spellings (and its ``resolve_config``
shim) have no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple, Union

from ..core.search import DEFAULT_SPLITS

__all__ = ["CodesignConfig", "ExecConfig", "ServeConfig"]


@dataclasses.dataclass(frozen=True)
class CodesignConfig:
    """Knobs of the joint schedule × buffer search (``Session.codesign``):
    ``strategy`` (registered name or strategy instance), ``capacity_bytes``
    (None → session capacity), ``max_orders``, ``splits``
    (explicit/implicit boundary candidates), ``overbook`` (fractional pin
    spill for sparse operands; the ``cuda`` backend runs an spmv op whose
    operand takes a prefix pin on kernel B3, which marks the prefix's loads
    evict_last in L2: a hint, kept by the card only within its persisting
    set-aside), ``use_cache`` (the disk cache of search results,
    ``api.cache``; None → the session's ``use_cache``)."""
    strategy: Any = "default"
    capacity_bytes: Optional[int] = None
    max_orders: int = 16
    splits: Sequence[float] = DEFAULT_SPLITS
    overbook: float = 0.0
    use_cache: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """Execution knobs (``Session.lower``, ``CompiledPlan.run`` /
    ``batched``): ``backend`` — any name registered in
    ``repro_torch.exec`` (None keeps the surface's default, ``"cuda"``);
    ``mesh`` — shard count ``K`` or ``(axis_name, K)``: ``Session.lower``
    partitions the co-designed DAG into K row blocks over the device
    slots of a solver mesh (``repro_torch.launch.mesh``; on one card all K
    share it).  The mesh is fixed when the plan is lowered: ``run`` and
    ``batched`` reject a config that names one."""
    backend: Optional[str] = None
    mesh: Optional[Union[int, Tuple[str, int]]] = None


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Batching + admission + resilience knobs of
    :class:`repro_torch.serve.Server`.

    ``retry`` takes a :class:`repro_torch.serve.RetryPolicy`;
    ``fallback=None`` disables backend fallback;
    ``breaker_failures=None`` disables the circuit breaker.
    """
    max_batch_size: int = 16
    max_wait_us: float = 2000.0
    max_plans: int = 8
    autostart: bool = True
    policy: str = "oldest"
    max_queue: Optional[int] = None
    overload: str = "block"
    retry: Optional[Any] = None
    fallback: Optional[str] = "reference"
    breaker_failures: Optional[int] = 3
    breaker_reset_s: float = 30.0
    max_worker_restarts: int = 2
