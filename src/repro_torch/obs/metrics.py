"""Thread-safe metrics registry: labeled counters, gauges, and streaming
histograms with quantile export (a copy of ``repro.obs.metrics``).

The registry is the single home for every runtime measurement the toolchain
emits — pipeline stage counters, executor dispatch/trace counts, serving
latency histograms.  One process-global default registry
(:func:`default_registry`) backs the instrumented layers; each instrument is
**defined exactly once** per (registry, name) — re-requesting the same name
returns the same instrument object, and requesting it with a different kind
raises.

Per-component exactness (a test asserting "this compiled plan dispatched
exactly twice") comes from **scope labels**: each instrumented object takes
a unique scope id (:func:`next_scope`) and reads back only its own label
cells, so two servers (or two compiled plans) in one process never alias
each other's counts while still sharing one registry definition.

Concurrency: one lock per registry guards every write *and*
:meth:`MetricsRegistry.snapshot`, so a snapshot is a consistent point-in-time
copy — no counter in it can be mid-update, and two counters bumped under an
outer caller lock (the serving layer does this) can never be observed torn.

Histograms are streaming: observations land in logarithmic buckets
(growth factor ``HIST_GROWTH``), so quantiles (p50/p90/p99) are estimated
within a documented relative error of ±5% (``HIST_REL_ERROR``) at O(1)
memory per distinct magnitude; exact ``count``/``sum``/``min``/``max`` ride
along, and quantile estimates are clamped into ``[min, max]``.
"""
from __future__ import annotations

import itertools
import math
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry", "next_scope", "HIST_GROWTH", "HIST_REL_ERROR",
]

#: log-bucket growth factor for streaming histograms
HIST_GROWTH = 1.1
#: documented relative quantile error bound: sqrt(growth) - 1 (~4.9%)
HIST_REL_ERROR = math.sqrt(HIST_GROWTH) - 1.0

_LOG_G = math.log(HIST_GROWTH)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


# --------------------------------------------------------------------------
# instruments
# --------------------------------------------------------------------------

class _Instrument:
    """Base: a named metric with labeled cells, bound to one registry."""

    kind = "base"

    def __init__(self, registry: "MetricsRegistry", name: str,
                 help: str = "", unit: str = ""):
        self.registry = registry
        self.name = name
        self.help = help
        self.unit = unit
        self._lock = registry._lock
        self._cells: Dict[LabelKey, Any] = {}

    def _new_cell(self):
        raise NotImplementedError

    def _cell(self, labels: Dict[str, Any]):
        key = _label_key(labels)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = self._new_cell()
            return cell

    def labels(self, **labels):
        """The bound cell for one label set (created on first use)."""
        return self._cell(labels)

    def __repr__(self) -> str:
        return (f"{type(self).__name__}({self.name!r}, "
                f"{len(self._cells)} cell(s))")


class _CounterCell:
    """Monotonic float cell; ``inc`` is atomic under the registry lock."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock):
        self._lock = lock
        self._value = 0.0

    def inc(self, value: float = 1.0) -> None:
        if value < 0:
            raise ValueError(f"counters only go up; inc({value})")
        with self._lock:
            self._value += value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Counter(_Instrument):
    """A monotonically increasing labeled count (requests, dispatches,
    cache hits, bytes)."""

    kind = "counter"

    def _new_cell(self):
        return _CounterCell(self._lock)

    def inc(self, value: float = 1.0, **labels) -> None:
        self._cell(labels).inc(value)

    def value(self, **labels) -> float:
        return self._cell(labels).value


class _GaugeCell:
    __slots__ = ("_lock", "_value")

    def __init__(self, lock):
        self._lock = lock
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def add(self, delta: float) -> None:
        with self._lock:
            self._value += delta

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Instrument):
    """A labeled point-in-time level (queue depth, resident plans)."""

    kind = "gauge"

    def _new_cell(self):
        return _GaugeCell(self._lock)

    def set(self, value: float, **labels) -> None:
        self._cell(labels).set(value)

    def add(self, delta: float, **labels) -> None:
        self._cell(labels).add(delta)

    def value(self, **labels) -> float:
        return self._cell(labels).value


class _HistogramCell:
    """Streaming log-bucket histogram cell.

    Positive observations land in bucket ``floor(log(x) / log(growth))``;
    zero/negative observations land in a dedicated underflow bucket (they
    represent "no elapsed time" for the duration histograms this backs).
    Quantiles interpolate at the bucket's geometric midpoint and are
    clamped into the exact observed ``[min, max]``.
    """

    __slots__ = ("_lock", "count", "sum", "min", "max", "_buckets",
                 "_underflow")

    def __init__(self, lock):
        self._lock = lock
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._buckets: Dict[int, int] = {}
        self._underflow = 0

    def observe(self, x: float) -> None:
        x = float(x)
        with self._lock:
            self.count += 1
            self.sum += x
            if x < self.min:
                self.min = x
            if x > self.max:
                self.max = x
            if x > 0.0:
                idx = math.floor(math.log(x) / _LOG_G)
                self._buckets[idx] = self._buckets.get(idx, 0) + 1
            else:
                self._underflow += 1

    # -- quantiles (call with the lock held or on a snapshot copy) -------
    def _quantile_locked(self, q: float) -> Optional[float]:
        if self.count == 0:
            return None
        # nearest-rank over the cumulative bucket counts
        rank = max(1, math.ceil(q * self.count))
        seen = self._underflow
        if rank <= seen:
            return max(self.min, 0.0) if self.min != math.inf else 0.0
        for idx in sorted(self._buckets):
            seen += self._buckets[idx]
            if rank <= seen:
                mid = math.exp((idx + 0.5) * _LOG_G)
                return min(max(mid, self.min), self.max)
        return self.max

    def quantile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (``0 <= q <= 1``), within
        ±\\ :data:`HIST_REL_ERROR` relative error of the sample quantile."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile q must be in [0, 1], got {q}")
        with self._lock:
            return self._quantile_locked(q)

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            if self.count == 0:
                return {"count": 0, "sum": 0.0, "mean": None, "min": None,
                        "max": None, "p50": None, "p90": None, "p99": None}
            return {
                "count": self.count,
                "sum": self.sum,
                "mean": self.sum / self.count,
                "min": self.min,
                "max": self.max,
                "p50": self._quantile_locked(0.50),
                "p90": self._quantile_locked(0.90),
                "p99": self._quantile_locked(0.99),
            }


class Histogram(_Instrument):
    """A labeled streaming distribution (latencies, sizes, bytes) with
    p50/p90/p99 export — see :class:`_HistogramCell` for the bucket math."""

    kind = "histogram"

    def _new_cell(self):
        return _HistogramCell(self._lock)

    def observe(self, x: float, **labels) -> None:
        self._cell(labels).observe(x)

    def quantile(self, q: float, **labels) -> Optional[float]:
        return self._cell(labels).quantile(q)

    def summary(self, **labels) -> Dict[str, Any]:
        return self._cell(labels).summary()


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------

class MetricsRegistry:
    """Name → instrument, with one lock guarding every write and snapshot.

    ``counter`` / ``gauge`` / ``histogram`` are get-or-define: the first
    call for a name defines the instrument, later calls return the same
    object (the "defined exactly once" contract); asking for an existing
    name with a different kind raises ``TypeError``.
    """

    def __init__(self):
        # RLock: instrument writes happen under callbacks that may already
        # hold the lock through snapshot() helpers
        self._lock = threading.RLock()
        self._instruments: Dict[str, _Instrument] = {}

    def _get_or_define(self, kind: str, name: str, help: str, unit: str):
        cls = _KINDS[kind]
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if inst.kind != kind:
                    raise TypeError(
                        f"metric {name!r} already defined as {inst.kind}, "
                        f"cannot redefine as {kind}")
                return inst
            inst = cls(self, name, help=help, unit=unit)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str = "", unit: str = "") -> Counter:
        return self._get_or_define("counter", name, help, unit)

    def gauge(self, name: str, help: str = "", unit: str = "") -> Gauge:
        return self._get_or_define("gauge", name, help, unit)

    def histogram(self, name: str, help: str = "",
                  unit: str = "") -> Histogram:
        return self._get_or_define("histogram", name, help, unit)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._instruments)

    # -- consistent export ----------------------------------------------
    def snapshot(self, scope: Optional[str] = None) -> Dict[str, Any]:
        """One consistent point-in-time copy of every instrument.

        The whole copy happens under the registry lock, so no cell is
        mid-update and counters bumped together under a caller's outer
        lock appear together.  ``scope`` filters to cells whose ``scope``
        label matches (instruments with no matching cell are dropped).
        Returns plain JSON-serializable data::

            {name: {"kind": ..., "help": ..., "unit": ...,
                    "cells": [{"labels": {...}, "value": ...}      # counter
                              {"labels": {...}, "value": {...}}]}} # histogram
        """
        with self._lock:
            out: Dict[str, Any] = {}
            for name in sorted(self._instruments):
                inst = self._instruments[name]
                cells = []
                for key, cell in sorted(inst._cells.items()):
                    labels = dict(key)
                    if scope is not None and labels.get("scope") != scope:
                        continue
                    if inst.kind == "histogram":
                        value: Any = cell.summary()
                    else:
                        value = cell.value
                    cells.append({"labels": labels, "value": value})
                if cells or scope is None:
                    out[name] = {"kind": inst.kind, "help": inst.help,
                                 "unit": inst.unit, "cells": cells}
            return out

    def reset(self) -> None:
        """Drop every instrument (tests only — instrumented modules keep
        handles to old instruments, so production code never calls this)."""
        with self._lock:
            self._instruments.clear()

    def __repr__(self) -> str:
        with self._lock:
            return f"MetricsRegistry({len(self._instruments)} instrument(s))"


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-global registry every instrumented layer writes to."""
    return _DEFAULT


_SCOPE_COUNTER = itertools.count(1)


def next_scope(prefix: str) -> str:
    """A unique scope-label value (``"serve-3"``): one per instrumented
    object, so per-object reads never alias across instances."""
    return f"{prefix}-{next(_SCOPE_COUNTER)}"


def merge_summaries(summaries: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge histogram summaries (count/sum/min/max only — quantiles do
    not merge; callers wanting merged quantiles should share one cell)."""
    count, total = 0, 0.0
    lo, hi = math.inf, -math.inf
    for s in summaries:
        if not s or not s.get("count"):
            continue
        count += s["count"]
        total += s["sum"]
        lo = min(lo, s["min"])
        hi = max(hi, s["max"])
    if count == 0:
        return {"count": 0, "sum": 0.0, "mean": None, "min": None,
                "max": None}
    return {"count": count, "sum": total, "mean": total / count,
            "min": lo, "max": hi}
