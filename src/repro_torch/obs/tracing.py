"""Span tracer (a copy of ``repro.obs.tracing``): nested wall-clock
spans, exportable as JSONL and Chrome ``trace_event`` JSON (loadable in
Perfetto / ``chrome://tracing``).

A span is one timed region with metadata::

    tr = default_tracer()
    with tr.span("session.codesign", arch="hpc:cg"):
        ...

Spans nest per thread (a thread-local stack tracks depth), so one
instrumented ``Session`` run yields the pipeline shape directly:
``session.trace`` → ``session.analyze`` → ``session.codesign`` (with
per-search-pass children) → ``session.lower`` → ``exec.compile`` /
``exec.dispatch``.

Disabled is the default and costs one method call and one check of the
profiler per span site: ``span()`` returns a shared no-op context manager,
allocates nothing, and records nothing (the <2% overhead policy in
``docs/observability.md``).  Enable via :func:`SpanTracer.enable`,
``repro_torch.obs.enable()``, or the ``CELLO_OBS`` environment variable.

Export schema (documented contract — ``scripts/obs_report.py --validate``
and the CI ``obs-smoke`` job check it):

* **JSONL** — one JSON object per line with exactly the keys
  ``name`` (str), ``ts_us`` (float, µs since tracer start), ``dur_us``
  (float ≥ 0), ``tid`` (int), ``pid`` (int), ``depth`` (int ≥ 0) and
  ``args`` (object).
* **Chrome** — ``{"displayTimeUnit": "ms", "traceEvents": [...]}`` where
  every event is a complete-duration event: ``ph == "X"`` with ``name``,
  ``ts``/``dur`` (µs), ``pid``, ``tid``, and the span metadata under
  ``args``.

While a ``torch.profiler`` session is active, every span, recorded or
not, also enters a ``torch.profiler.record_function`` range of its name,
so CELLO pipeline stages line up with the CUDA kernels and graph launches
inside the profiler's trace whether or not the tracer is enabled (where
the JAX package mirrors its spans into ``jax.profiler.TraceAnnotation``
on request).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from torch._C._autograd import _profiler_enabled

__all__ = [
    "SpanTracer", "default_tracer", "JSONL_KEYS",
    "load_jsonl", "validate_jsonl", "validate_chrome",
]

#: exactly the keys every exported JSONL span carries
JSONL_KEYS = ("name", "ts_us", "dur_us", "tid", "pid", "depth", "args")


class _NullSpan:
    """The shared disabled-path context manager: no state, no allocation."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **kv) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


def _profiler_range(name: str):
    from torch.profiler import record_function
    return record_function(name)


class _RangeSpan:
    """A span the disabled tracer hands out while a ``torch.profiler``
    session is active: the profiler's range alone, nothing recorded."""

    __slots__ = ("_ctx",)

    def __init__(self, name: str):
        self._ctx = _profiler_range(name)

    def __enter__(self):
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)
        return False

    def annotate(self, **kv) -> "_RangeSpan":
        return self


class _Span:
    """One live span: records itself on exit."""

    __slots__ = ("tracer", "name", "args", "_t0", "_depth", "_prof_ctx")

    def __init__(self, tracer: "SpanTracer", name: str,
                 args: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.args = args
        self._t0 = 0.0
        self._depth = 0
        self._prof_ctx = None

    def __enter__(self):
        tr = self.tracer
        stack = tr._stack()
        self._depth = len(stack)
        stack.append(self)
        if _profiler_enabled():
            self._prof_ctx = _profiler_range(self.name)
            self._prof_ctx.__enter__()
        self._t0 = time.perf_counter()
        return self

    def annotate(self, **kv) -> "_Span":
        """Attach metadata discovered mid-span (cache hit, batch size)."""
        self.args.update(kv)
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._prof_ctx is not None:
            self._prof_ctx.__exit__(*exc)
        tr = self.tracer
        stack = tr._stack()
        if stack and stack[-1] is self:
            stack.pop()
        tr._record(self.name, self._t0 - tr._epoch, t1 - self._t0,
                   self._depth, self.args)
        return False


class SpanTracer:
    """Collects spans from every thread; exports JSONL / Chrome JSON."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._epoch = time.perf_counter()
        self._epoch_unix = time.time()
        self._records: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    # -- span API --------------------------------------------------------
    def span(self, name: str, **args):
        """A nested timed region.  Disabled tracers return a shared no-op
        context manager (identity-stable — the zero-overhead path), or,
        while a ``torch.profiler`` session is active, the profiler's range
        of ``name`` alone."""
        if self.enabled:
            return _Span(self, name, args)
        if _profiler_enabled():
            return _RangeSpan(name)
        return _NULL_SPAN

    def record(self, name: str, start_s: float, dur_s: float, *,
               depth: Optional[int] = None, **args) -> None:
        """Record a synthetic (already-timed) span.  ``start_s`` is tracer
        time (:meth:`now`).  Used where real intervals are not observable —
        e.g. the lazily-streamed search passes report aggregate self-time."""
        if not self.enabled:
            return
        if depth is None:
            depth = len(self._stack())
        self._record(name, start_s, max(dur_s, 0.0), depth, args)

    def now(self) -> float:
        """Seconds since this tracer's epoch (span timestamps' timebase)."""
        return time.perf_counter() - self._epoch

    # -- lifecycle -------------------------------------------------------
    def enable(self) -> "SpanTracer":
        self.enabled = True
        return self

    def disable(self) -> "SpanTracer":
        self.enabled = False
        return self

    def clear(self) -> None:
        with self._lock:
            self._records.clear()

    # -- internals -------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, name: str, start_s: float, dur_s: float, depth: int,
                args: Dict[str, Any]) -> None:
        rec = {
            "name": name,
            "ts_us": start_s * 1e6,
            "dur_us": dur_s * 1e6,
            "tid": threading.get_ident(),
            "pid": os.getpid(),
            "depth": depth,
            "args": _jsonable(args),
        }
        with self._lock:
            self._records.append(rec)

    # -- export ----------------------------------------------------------
    def spans(self) -> List[Dict[str, Any]]:
        """A time-ordered copy of every recorded span."""
        with self._lock:
            return sorted(self._records, key=lambda r: r["ts_us"])

    def export_jsonl(self, path: os.PathLike) -> int:
        """Write one JSON object per span (schema: :data:`JSONL_KEYS`).
        Returns the number of spans written."""
        spans = self.spans()
        with open(path, "w") as f:
            for rec in spans:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
        return len(spans)

    def to_chrome(self) -> Dict[str, Any]:
        """Chrome ``trace_event`` JSON (complete ``"X"`` events; nesting is
        implied by interval containment per tid, which the per-thread span
        stack guarantees)."""
        events = []
        for rec in self.spans():
            events.append({
                "name": rec["name"],
                "ph": "X",
                "ts": rec["ts_us"],
                "dur": rec["dur_us"],
                "pid": rec["pid"],
                "tid": rec["tid"],
                "cat": rec["name"].split(".", 1)[0],
                "args": rec["args"],
            })
        return {"displayTimeUnit": "ms", "traceEvents": events,
                "otherData": {"unix_epoch_s": self._epoch_unix}}

    def export_chrome(self, path: os.PathLike) -> int:
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f, sort_keys=True)
        return len(doc["traceEvents"])


_DEFAULT = SpanTracer()


def default_tracer() -> SpanTracer:
    """The process-global tracer every instrumented layer emits to."""
    return _DEFAULT


# --------------------------------------------------------------------------
# schema validation (the documented export contract; CI's obs-smoke gate)
# --------------------------------------------------------------------------

def load_jsonl(path: os.PathLike) -> List[Dict[str, Any]]:
    spans = []
    with open(path) as f:
        for line in f:
            if line.strip():
                spans.append(json.loads(line))
    return spans


def _check_span(rec: Dict[str, Any], where: str) -> None:
    if not isinstance(rec, dict):
        raise ValueError(f"{where}: span is not an object")
    missing = [k for k in JSONL_KEYS if k not in rec]
    if missing:
        raise ValueError(f"{where}: missing keys {missing}")
    extra = sorted(set(rec) - set(JSONL_KEYS))
    if extra:
        raise ValueError(f"{where}: unexpected keys {extra}")
    if not isinstance(rec["name"], str) or not rec["name"]:
        raise ValueError(f"{where}: name must be a non-empty string")
    for k in ("ts_us", "dur_us"):
        if not isinstance(rec[k], (int, float)) or rec[k] < 0:
            raise ValueError(f"{where}: {k} must be a number >= 0")
    for k in ("tid", "pid", "depth"):
        if not isinstance(rec[k], int) or rec[k] < 0:
            raise ValueError(f"{where}: {k} must be an int >= 0")
    if not isinstance(rec["args"], dict):
        raise ValueError(f"{where}: args must be an object")


def validate_jsonl(path: os.PathLike) -> int:
    """Check a JSONL span export against the documented schema.  Returns
    the span count; raises ``ValueError`` on the first violation."""
    spans = load_jsonl(path)
    for i, rec in enumerate(spans):
        _check_span(rec, f"{path}:{i + 1}")
    return len(spans)


def validate_chrome(path: os.PathLike) -> int:
    """Check a Chrome ``trace_event`` export: a ``traceEvents`` list of
    complete (``ph == "X"``) events with µs timestamps.  Returns the event
    count; raises ``ValueError`` on the first violation."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError(f"{path}: not a trace_event document "
                         "(no traceEvents key)")
    events = doc["traceEvents"]
    if not isinstance(events, list):
        raise ValueError(f"{path}: traceEvents must be a list")
    for i, ev in enumerate(events):
        where = f"{path}: event {i}"
        if not isinstance(ev, dict):
            raise ValueError(f"{where}: not an object")
        if ev.get("ph") != "X":
            raise ValueError(f"{where}: ph must be 'X' (complete event), "
                             f"got {ev.get('ph')!r}")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            raise ValueError(f"{where}: name must be a non-empty string")
        for k in ("ts", "dur"):
            if not isinstance(ev.get(k), (int, float)) or ev[k] < 0:
                raise ValueError(f"{where}: {k} must be a number >= 0")
        for k in ("pid", "tid"):
            if not isinstance(ev.get(k), int):
                raise ValueError(f"{where}: {k} must be an int")
        if "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(f"{where}: args must be an object")
    return len(events)


def _jsonable(args: Dict[str, Any]) -> Dict[str, Any]:
    """Span metadata must serialize: keep JSON scalars, repr the rest."""
    out = {}
    for k, v in args.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            out[k] = repr(v)
    return out
