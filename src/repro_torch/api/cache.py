"""Disk cache for the port's co-design results.

The counterpart of ``repro.api.cache``: the search is deterministic, so its
result is kept on disk as JSON, one file per key, and replayed instead of
searched again.  The key covers the traced graph's content, the hardware
model, the capacity, the search knobs, the strategy's code and the code of
the search itself, so no change to any of them can replay a stale entry.

JSON round-trips Python floats exactly (``float(repr(x)) == x``), so a hit
is bit-identical to the search that produced it.

The port and the JAX package never replay each other's entries.  Every key
carries ``package="repro_torch"`` (the JAX package's keys carry no such
field, so no key of one is a key of the other), and ``algo_fingerprint`` /
``frontend_fingerprint`` hash the port's own sources.  The default
directory is the port's own, ``~/.cache/cello/codesign-torch``, beside the
JAX package's ``~/.cache/cello/codesign``.  ``CELLO_CACHE_DIR`` names one
directory for both packages when it is set: they share it, and the package
field keeps their entries apart.  ``CELLO_NO_CACHE`` (any value but ``""``,
``0`` or ``false``) turns the cache off for both.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import inspect
import json
import logging
import os
import pathlib
import re
import tempfile
from typing import Any, Dict, Optional

from .. import obs
from ..testing import faults
from ..core.buffer import BufferConfig, TrafficReport
from ..core.costmodel import HardwareModel, Metrics
from ..core.graph import OpGraph
from ..core.schedule import (CoDesignResult, EvaluatedSchedule, PartialPin,
                             PinSet, Schedule)

_FORMAT_VERSION = 1
#: the key field that names the package whose search wrote an entry
PACKAGE = "repro_torch"

_CACHE_HITS = obs.registry().counter(
    "codesign.cache.hits", "codesign disk-cache entries replayed")
_CACHE_MISSES = obs.registry().counter(
    "codesign.cache.misses",
    "codesign disk-cache lookups that re-searched (absent/corrupt/stale)")
_CACHE_CORRUPT = obs.registry().counter(
    "codesign.cache.corrupt",
    "codesign disk-cache entries found corrupt/truncated/stale-format "
    "(logged, deleted, re-derived — also counted in misses)")
_CACHE_READ_B = obs.registry().counter(
    "codesign.cache.read_bytes", "bytes read on codesign cache hits",
    unit="B")
_CACHE_WRITE_B = obs.registry().counter(
    "codesign.cache.write_bytes", "bytes published to the codesign cache",
    unit="B")


def default_cache_dir() -> pathlib.Path:
    """``$CELLO_CACHE_DIR`` when set (shared with the JAX package), else
    ``~/.cache/cello/codesign-torch``."""
    env = os.environ.get("CELLO_CACHE_DIR")
    if env:
        return pathlib.Path(env).expanduser()
    return pathlib.Path("~/.cache/cello/codesign-torch").expanduser()


def cache_disabled_by_env() -> bool:
    # CELLO_NO_CACHE=0 / =false / ="" means "leave caching on"
    return os.environ.get("CELLO_NO_CACHE", "").lower() not in ("", "0", "false")


def graph_fingerprint(graph: OpGraph) -> str:
    """Content hash over tensors + ops (shapes, dtypes, kinds, FLOPs)."""
    h = hashlib.sha256()
    for t in graph.tensors.values():
        h.update(repr((t.name, t.shape, t.dtype_bytes, t.kind.value,
                       t.meta)).encode())
    for o in graph.topo_order():
        op = graph.ops[o]
        h.update(repr((op.name, op.spec, op.inputs, op.output, op.flops,
                       op.irregular)).encode())
    return h.hexdigest()


def hw_fingerprint(hw: HardwareModel) -> str:
    return hashlib.sha256(repr(dataclasses.astuple(hw)).encode()).hexdigest()


def frontend_fingerprint(program) -> Optional[str]:
    """Cache-key component for frontend-built (HPC) graphs: the expression
    DAG's content hash plus the port's frontend lowering code, so an edit
    to ``frontends.expr`` invalidates entries even when the lowered graph
    would hash the same.  ``None`` for registry (LLM) traces."""
    if program is None:
        return None
    from ..frontends import expr
    h = hashlib.sha256(program.fingerprint().encode())
    try:
        h.update(inspect.getsource(expr).encode())
    except OSError:                    # no source (zipapp etc.)
        from .. import __version__
        h.update(__version__.encode())
    return h.hexdigest()


def strategy_fingerprint(strategy) -> Optional[str]:
    """Hash of the strategy implementation's source code and instance state.

    ``algo_fingerprint`` only covers the core modules, so a user-registered
    strategy edited between runs would otherwise replay a stale search
    under its unchanged name, and two differently configured instances of
    one class must not alias each other's entries.  Returns None when the
    source is unavailable (e.g. a REPL-defined class) or the state's repr
    holds an address: the caller must then skip the disk cache."""
    try:
        # the whole MRO (minus object): an edited user base class holding
        # orders() must invalidate entries keyed by an unchanged subclass
        src = "\0".join(inspect.getsource(klass)
                        for klass in type(strategy).__mro__
                        if klass is not object)
    except (OSError, TypeError):
        return None
    attrs = dict(getattr(strategy, "__dict__", {}))
    for klass in type(strategy).__mro__:      # __slots__-based state too
        slots = getattr(klass, "__slots__", ())
        for slot in ((slots,) if isinstance(slots, str) else slots):
            if hasattr(strategy, slot):
                attrs[slot] = getattr(strategy, slot)
    state = repr(sorted(attrs.items()))
    if re.search(r"0x[0-9a-fA-F]{6,}", state):
        # address-bearing default reprs differ per process: the key would
        # never repeat, a permanent silent miss
        return None
    return hashlib.sha256((src + "\0" + state).encode()).hexdigest()


@functools.lru_cache(maxsize=1)
def algo_fingerprint() -> str:
    """Hash of the port's search / simulator / cost-model source code: any
    edit to the co-design arithmetic invalidates old entries."""
    from ..core import buffer, costmodel, graph, reuse, schedule, search
    h = hashlib.sha256()
    for mod in (buffer, costmodel, graph, reuse, schedule, search):
        try:
            h.update(inspect.getsource(mod).encode())
        except OSError:       # no source (zipapp etc.): fall back to version
            from .. import __version__
            h.update(__version__.encode())
    return h.hexdigest()


# --------------------------------------------------------------------------
# (de)serialization
# --------------------------------------------------------------------------

def _sched_to(s: Schedule) -> Dict[str, Any]:
    out = {
        "order": list(s.order),
        "groups": [list(g) for g in s.groups],
        "pins": {t: list(ab) for t, ab in s.pins.items()},
        "config": dataclasses.asdict(s.config),
    }
    partial = getattr(s.pins, "partial", None)
    if partial:
        out["partial"] = {t: dataclasses.asdict(pp)
                          for t, pp in partial.items()}
    return out


def _sched_from(d: Dict[str, Any]) -> Schedule:
    pins = PinSet({t: tuple(ab) for t, ab in d["pins"].items()})
    for t, pp in d.get("partial", {}).items():
        pins.partial[t] = PartialPin(**pp)
    return Schedule(
        order=list(d["order"]),
        groups=[list(g) for g in d["groups"]],
        pins=pins,
        config=BufferConfig(**d["config"]),
    )


def _ev_to(ev: EvaluatedSchedule) -> Dict[str, Any]:
    return {
        "schedule": _sched_to(ev.schedule),
        "report": dataclasses.asdict(ev.report),
        "metrics": dataclasses.asdict(ev.metrics),
    }


def _ev_from(d: Dict[str, Any]) -> EvaluatedSchedule:
    return EvaluatedSchedule(
        schedule=_sched_from(d["schedule"]),
        report=TrafficReport(**d["report"]),
        metrics=Metrics(**d["metrics"]),
    )


def result_to_dict(res: CoDesignResult) -> Dict[str, Any]:
    return {
        "v": _FORMAT_VERSION,
        "best": _ev_to(res.best),
        "baselines": {k: _ev_to(v) for k, v in res.baselines.items()},
        # float keys serialized by repr so they round-trip exactly
        "split_sweep": {repr(k): dataclasses.asdict(v)
                        for k, v in res.split_sweep.items()},
        "overbook": res.overbook,
    }


def result_from_dict(d: Dict[str, Any]) -> CoDesignResult:
    if d.get("v") != _FORMAT_VERSION:
        raise ValueError(f"cache format {d.get('v')!r} != {_FORMAT_VERSION}")
    return CoDesignResult(
        best=_ev_from(d["best"]),
        baselines={k: _ev_from(v) for k, v in d["baselines"].items()},
        split_sweep={float(k): Metrics(**v)
                     for k, v in d["split_sweep"].items()},
        overbook=d.get("overbook", 0.0),
    )


# --------------------------------------------------------------------------
# the cache
# --------------------------------------------------------------------------

class CodesignCache:
    """One JSON file per key under ``root`` (atomic, best-effort writes).

    Every writer serializes into its own ``mkstemp`` temp file and
    publishes it with one atomic ``os.replace`` onto the final path;
    readers open only the final path, so they see a complete entry or
    none, never a torn write.  Racing writers of one key are
    last-writer-wins, which is safe because the search is deterministic.
    Failures (read-only directory, full disk) degrade to a miss or a
    no-op: caching is best-effort and the computed result always stands.
    """

    def __init__(self, root: Optional[os.PathLike] = None):
        self.root = pathlib.Path(root) if root else default_cache_dir()

    @staticmethod
    def key(**fields: Any) -> str:
        """The entry's name: a hash of ``fields`` and of ``PACKAGE``."""
        blob = json.dumps({**fields, "package": PACKAGE}, sort_keys=True,
                          default=repr)
        return hashlib.sha256(blob.encode()).hexdigest()

    def _path(self, key: str) -> pathlib.Path:
        return self.root / f"{key}.json"

    def get(self, key: str) -> Optional[CoDesignResult]:
        path = self._path(key)
        try:
            with open(path) as f:
                blob = f.read()
        except OSError:
            _CACHE_MISSES.inc()
            return None    # absent (or unreadable): plain miss, re-search
        # fault-injection site: codesign.cache — a corrupt rule truncates
        # the entry as if the disk had
        blob = faults.corrupt_text("codesign.cache", blob)
        try:
            res = result_from_dict(json.loads(blob))
        except (ValueError, KeyError, TypeError):
            # corrupt / truncated / stale-format entry: count it, drop the
            # bad file so the re-derived result can be re-published, and
            # re-search — never raise out of a cache read
            _CACHE_CORRUPT.inc()
            _CACHE_MISSES.inc()
            logging.getLogger(__name__).warning(
                "codesign cache entry %s is corrupt or stale; deleting "
                "and re-deriving", path.name)
            try:
                os.unlink(path)
            except OSError:
                pass
            return None
        _CACHE_HITS.inc()
        _CACHE_READ_B.inc(len(blob))
        return res

    def put(self, key: str, res: CoDesignResult) -> None:
        tmp = None
        try:
            blob = json.dumps(result_to_dict(res))
            self.root.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                f.write(blob)
            os.replace(tmp, self._path(key))
            tmp = None
            _CACHE_WRITE_B.inc(len(blob))
        except OSError:
            pass           # caching is best-effort; the search result stands
        finally:
            if tmp is not None:     # failed mid-write: don't orphan the .tmp
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
