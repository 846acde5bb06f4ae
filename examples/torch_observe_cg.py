"""Trace one instrumented CG pipeline run end to end with ``repro_torch.obs``.

The PyTorch/CUDA twin of ``examples/observe_cg.py``: the same flags and
printed lines, and the same span names, with the ``cuda`` backend's run
stages beside them.  Runs the staged pipeline explicitly — ``trace →
analyze → codesign → lower → run`` — with span tracing enabled, so the
exported trace carries all four ``session.*`` stage spans, the nested
``codesign.search`` span with its per-pass children, and the
``exec.compile`` / ``exec.dispatch`` spans (under the latter, on the
``cuda`` backend, ``exec.feed`` / ``exec.replay`` / ``exec.copy_out``).  Writes a
Chrome ``trace_event`` file you can load directly in
https://ui.perfetto.dev, then prints the span timeline and the
metrics-registry table (the renderings of ``scripts/obs_report.py``).

    PYTHONPATH=src python examples/torch_observe_cg.py --n 256 --iters 8 \\
        --trace /tmp/cello.trace.json

``--backend cuda`` (the default) runs the plan on the hand-written
kernels (B1's stream passes); ``reference`` replays it through the torch
interpreter.  ``--device cuda`` (the default) raises without a card;
``--device cpu`` runs the kernels' plain torch versions.  Any entry point
can be traced without code changes via the environment:
``CELLO_OBS=chrome:/tmp/cello.trace.json python ...``
(see docs/observability.md).  ``main(argv)`` returns what it printed as
data.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import tempfile
from typing import Any, Dict, List

from repro_torch import obs
from repro_torch.api import Session


def _fmt_args(args: Dict[str, Any]) -> str:
    return " ".join(f"{k}={v}" for k, v in sorted(args.items()))


def span_lines(spans: List[Dict[str, Any]]) -> List[str]:
    """The span timeline (indent = depth) and a per-name aggregate, as
    ``scripts/obs_report.py`` renders them."""
    lines = [f"{'ts_ms':>10}  {'dur_ms':>10}  span"]
    totals: Dict[str, List[float]] = {}
    for rec in spans:
        name, dur_ms = rec["name"], rec["dur_us"] / 1e3
        indent = "  " * rec.get("depth", 0)
        args = _fmt_args(rec.get("args") or {})
        lines.append(f"{rec['ts_us'] / 1e3:10.3f}  {dur_ms:10.3f}  "
                     f"{indent}{name}" + (f"  [{args}]" if args else ""))
        totals.setdefault(name, []).append(dur_ms)
    lines.append("")
    lines.append(f"{'count':>6}  {'total_ms':>10}  {'mean_ms':>10}  name")
    for name in sorted(totals):
        ds = totals[name]
        lines.append(f"{len(ds):6d}  {sum(ds):10.3f}  "
                     f"{sum(ds) / len(ds):10.3f}  {name}")
    return lines


def render_chrome(path: str) -> List[str]:
    """A Chrome trace's spans, nested by interval containment."""
    with open(path) as f:
        doc = json.load(f)
    spans = [{"name": ev.get("name", "?"), "ts_us": ev.get("ts", 0),
              "dur_us": ev.get("dur", 0), "depth": 0,
              "args": ev.get("args") or {}}
             for ev in doc.get("traceEvents", [])]
    spans.sort(key=lambda r: r["ts_us"])
    open_until: List[float] = []
    for rec in spans:
        while open_until and rec["ts_us"] >= open_until[-1] - 1e-9:
            open_until.pop()
        rec["depth"] = len(open_until)
        open_until.append(rec["ts_us"] + rec["dur_us"])
    return span_lines(spans)


def render_metrics(snap: Dict[str, Any]) -> List[str]:
    """One row per labeled cell of a metrics snapshot; histograms with
    count / mean / p50 / p90 / p99 / max."""
    lines: List[str] = []
    for name in sorted(snap):
        inst = snap[name]
        unit = f" [{inst['unit']}]" if inst.get("unit") else ""
        lines.append(f"{name}{unit}  ({inst['kind']})"
                     + (f" — {inst['help']}" if inst.get("help") else ""))
        for cell in inst.get("cells", []):
            labels = _fmt_args(cell.get("labels") or {}) or "-"
            v = cell.get("value")
            if isinstance(v, dict):                    # histogram summary
                if not v.get("count"):
                    lines.append(f"    {labels:48s}  count=0")
                    continue
                qs = "  ".join(
                    f"{q}={v[q]:.6g}" for q in
                    ("mean", "p50", "p90", "p99", "max")
                    if v.get(q) is not None)
                lines.append(f"    {labels:48s}  count={v['count']}  {qs}")
            else:
                num = f"{v:g}" if isinstance(v, float) else str(v)
                lines.append(f"    {labels:48s}  {num}")
    return lines or ["(empty snapshot)"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=256, help="operator size")
    ap.add_argument("--iters", type=int, default=8, help="CG iterations")
    ap.add_argument("--backend", default="cuda",
                    help="execution backend (cuda | reference)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="Chrome trace output (default: a temp file)")
    ap.add_argument("--jsonl", default=None, metavar="PATH",
                    help="also write the JSONL span export to PATH")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; raises without a card) or cpu "
                         "(their plain torch versions)")
    args = ap.parse_args(argv)
    trace_path = args.trace or str(pathlib.Path(tempfile.gettempdir())
                                   / "cello.trace.json")

    obs.enable(chrome=trace_path, jsonl=args.jsonl)

    # the four stages explicitly (Session.compile() would skip analyze),
    # so the exported trace shows the full pipeline shape
    sess = Session(device=args.device)
    traced = sess.trace(workload="cg", n=args.n, iters=args.iters)
    analyzed = traced.analyze()
    designed = analyzed.codesign()
    plan = designed.lower(backend=args.backend)
    with obs.span("example.run", backend=args.backend):
        out = plan.run()

    counts = obs.flush()
    print(f"residual leaves: {sorted(out)}")
    print(f"wrote {counts[trace_path]} spans -> {trace_path} "
          "(load in https://ui.perfetto.dev)\n")

    timeline = render_chrome(trace_path)
    print("# span timeline")
    print("\n".join(timeline))
    metrics = render_metrics(obs.snapshot())
    print("\n# metrics registry")
    print("\n".join(metrics))

    names = {rec["name"] for rec in obs.tracer().spans()}
    for stage in ("trace", "analyze", "codesign", "lower"):
        assert f"session.{stage}" in names, f"missing session.{stage}"
    print("\nall four pipeline stage spans recorded: verified")
    return {"outputs": {k: v.cpu().numpy() for k, v in out.items()},
            "trace": trace_path, "spans_written": counts[trace_path],
            "span_names": sorted(names), "timeline": timeline,
            "metrics": metrics}


if __name__ == "__main__":
    main()
