"""`repro_torch.obs` — the port's observability layer: metrics + span
tracing.

A copy of ``repro.obs`` (same instruments, metric names, snapshot shape,
export schemas and ``CELLO_OBS`` grammar; ``docs/observability.md``).  The
port keeps its own registry and tracer: a process that holds both packages
has two of each.  Two process-global primitives back every instrumented
layer of the port:

* :func:`registry` — a thread-safe
  :class:`~repro_torch.obs.metrics.MetricsRegistry`
  of labeled counters, gauges, and streaming histograms (p50/p90/p99
  export).  ``Session`` stages, the codesign disk cache, execution
  backends, and the serving layer all define their instruments here
  exactly once; ``registry().snapshot()`` is one consistent point-in-time
  copy.
* :func:`tracer` — a :class:`~repro_torch.obs.tracing.SpanTracer` of nested
  wall-clock spans, exportable as JSONL or Chrome ``trace_event`` JSON
  (Perfetto-loadable).  Disabled by default at near-zero cost; enable in
  code (:func:`enable`) or via the environment::

      CELLO_OBS=jsonl:cello.jsonl python3 my_solver.py
      CELLO_OBS=chrome:cello.trace.json python3 my_solver.py

  ``CELLO_OBS`` accepts a comma-separated list of ``jsonl:PATH`` /
  ``chrome:PATH`` sinks (flushed at interpreter exit and on
  :func:`flush`), or just ``1`` to enable tracing with no sink.
  Spans need no switch to show in the framework's profiler: while a
  ``torch.profiler`` session is active, each span enters a
  ``torch.profiler.record_function`` range, enabled or not, which shows
  in the trace beside the kernels it launched.  ``torchprof`` and the JAX
  package's ``jaxprof``, which switch its mirror on, are accepted and
  switch nothing here, so one ``CELLO_OBS`` serves both packages.

Render either artifact with ``python scripts/obs_report.py FILE``.
"""
from __future__ import annotations

import atexit
import os
import warnings
from typing import Any, Dict, List, Optional, Tuple

from .metrics import (Counter, Gauge, HIST_GROWTH, HIST_REL_ERROR,
                      Histogram, MetricsRegistry, default_registry,
                      merge_summaries, next_scope)
from .tracing import (JSONL_KEYS, SpanTracer, default_tracer, load_jsonl,
                      validate_chrome, validate_jsonl)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "SpanTracer",
    "HIST_GROWTH", "HIST_REL_ERROR", "JSONL_KEYS",
    "registry", "tracer", "span", "enable", "disable", "flush",
    "default_registry", "default_tracer", "next_scope", "merge_summaries",
    "load_jsonl", "validate_chrome", "validate_jsonl",
    "configure_from_env",
]


def registry() -> MetricsRegistry:
    """The process-global metrics registry."""
    return default_registry()


def tracer() -> SpanTracer:
    """The process-global span tracer."""
    return default_tracer()


def span(name: str, **args):
    """Convenience: a span on the global tracer (no-op when disabled)."""
    return default_tracer().span(name, **args)


# -- sinks ------------------------------------------------------------------

#: (format, path) sinks flushed by :func:`flush` and at interpreter exit
_SINKS: List[Tuple[str, str]] = []
_ATEXIT_REGISTERED = False


def _register_atexit() -> None:
    global _ATEXIT_REGISTERED
    if not _ATEXIT_REGISTERED:
        _ATEXIT_REGISTERED = True
        atexit.register(flush)


def flush() -> Dict[str, int]:
    """Write every configured sink now.  Returns ``{path: span count}``.
    Failures warn (observability must never take the workload down)."""
    out: Dict[str, int] = {}
    tr = default_tracer()
    for fmt, path in list(_SINKS):
        try:
            if fmt == "jsonl":
                out[path] = tr.export_jsonl(path)
            else:
                out[path] = tr.export_chrome(path)
        except OSError as e:                             # pragma: no cover
            warnings.warn(f"obs sink {fmt}:{path} failed: {e}",
                          stacklevel=2)
    return out


def enable(*, jsonl: Optional[str] = None,
           chrome: Optional[str] = None) -> SpanTracer:
    """Turn span tracing on, optionally attaching export sinks."""
    tr = default_tracer().enable()
    for fmt, path in (("jsonl", jsonl), ("chrome", chrome)):
        if path:
            _SINKS.append((fmt, str(path)))
            _register_atexit()
    return tr


def disable() -> SpanTracer:
    """Turn span tracing off (sinks stay configured; flush still works)."""
    return default_tracer().disable()


def configure_from_env(env: Optional[str] = None) -> bool:
    """Apply the ``CELLO_OBS`` spec (see module docstring).  Called once at
    import; returns True when tracing was enabled.  A malformed spec warns
    and is ignored — observability must never break the import."""
    spec = os.environ.get("CELLO_OBS", "") if env is None else env
    spec = spec.strip()
    if not spec or spec.lower() in ("0", "false", "off", "no"):
        return False
    sinks: List[Tuple[str, str]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if part.lower() in ("1", "true", "on", "yes"):
            continue                     # enable, no sink
        if part.lower() in ("torchprof", "torch_profiler", "jaxprof",
                            "jax_profiler"):
            continue                     # spans reach the profiler anyway
        fmt, sep, path = part.partition(":")
        if sep and fmt.lower() in ("jsonl", "chrome", "trace") and path:
            sinks.append(("jsonl" if fmt.lower() == "jsonl" else "chrome",
                          path))
        else:
            warnings.warn(
                f"CELLO_OBS: unrecognized part {part!r} (want 1, torchprof, "
                "jsonl:PATH or chrome:PATH) — ignored", stacklevel=2)
    enable()
    for fmt, path in sinks:
        _SINKS.append((fmt, path))
    if sinks:
        _register_atexit()
    return True


def snapshot(scope: Optional[str] = None) -> Dict[str, Any]:
    """Convenience: one consistent metrics snapshot off the global
    registry."""
    return default_registry().snapshot(scope)


configure_from_env()
