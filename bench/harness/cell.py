"""One run of one cell: set-up, the measured window, the traced window
(``--trace 1``), the comparison with the plain reference, the result.

``run_cell`` takes the device to run on and does not look for a card
itself (``run.py`` does), so the tests can drive a whole run on the CPU at
a small size, where every kernel of the program runs its plain version.
"""
from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from bench import counts
from bench.harness import guard, judge
from bench.harness.devtrace import Traced
from bench.harness.traffic import DTYPES, traffic_for


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


class Record:
    """What the per-layer readers (``metrics/<metric>.py``) read: the
    benchmark's own spans, the program's ``obs`` counters over the measured
    and the traced windows, and the device trace."""

    def __init__(self, cell, cfg, mix, spans, window, traced, snaps,
                 trace_snaps):
        self.cell, self.cfg, self.mix = cell, cfg, mix
        self.counts = counts
        self.spans = spans
        self.window = window
        self.traced = traced
        self._snaps = {False: snaps, True: trace_snaps}

    def _cells(self, name: str, traced: bool, end: int):
        snap = self._snaps[traced][end]
        return snap.get(name, {}).get("cells", [])

    def counter_delta(self, name: str, traced: bool = False) -> float:
        return (sum(c["value"] for c in self._cells(name, traced, 1))
                - sum(c["value"] for c in self._cells(name, traced, 0)))

    def label_deltas(self, name: str, label: str, traced: bool = False
                     ) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for end, sign in ((1, 1.0), (0, -1.0)):
            for c in self._cells(name, traced, end):
                key = c["labels"].get(label)
                out[key] = out.get(key, 0.0) + sign * c["value"]
        return out

    def hist_delta(self, name: str, traced: bool = False
                   ) -> Tuple[float, float]:
        """(count, sum) of a histogram's observations in the window."""
        cnt = tot = 0.0
        for end, sign in ((1, 1.0), (0, -1.0)):
            for c in self._cells(name, traced, end):
                cnt += sign * c["value"]["count"]
                tot += sign * c["value"]["sum"]
        return cnt, tot


def served_p95_ms(w) -> float:
    """The 95th percentile of the window's completed requests' latencies."""
    return float(np.percentile(w.latencies_s, 95)) * 1e3


def end_to_end(name: str, w, setup_s: float) -> float:
    if name == "setup_s":
        return setup_s
    if name == "solve_ms":
        return w.seconds / w.completed * 1e3
    if name == "served_rps":
        return w.completed / w.seconds
    if name == "served_p95_ms":
        return served_p95_ms(w)
    raise KeyError(f"no end-to-end metric {name!r}")


def _finite(v: float):
    return v if math.isfinite(v) else repr(v)


def run_cell(spec, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", run_dtype: Optional[str] = None
             ) -> Tuple[dict, List[str]]:
    """Run the cell; return the result object and the lines that give each
    compared number beside its limit.  ``run_dtype`` feeds the program in
    another precision than the configuration states (the control), while
    the reference keeps the configuration's."""
    import torch
    from repro_torch import obs
    cell = spec.cell(name)
    cfg = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    limits = spec.limits(name)
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    tr = traffic_for(spec, cfg, mix, seed, device, run_dtype)
    t0 = time.perf_counter()
    tr.make_inputs()
    inputs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr.make_plan()
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr.warm()
    warm_s = time.perf_counter() - t0
    setup_s = guard.process_age_s()
    log(f"set-up {setup_s:.3f} s (inputs {inputs_s:.3f} s, plan "
        f"{plan_s:.3f} s, warm {warm_s:.3f} s)")

    snaps = [obs.snapshot()]
    w = tr.window(seconds)
    snaps.append(obs.snapshot())
    log(f"window {w.seconds:.3f} s: {w.completed} completed, "
        f"{w.attempted} attempted, {w.failed} failed"
        + (f", p95 {served_p95_ms(w)!r} ms" if w.latencies_s else ""))
    traced = trace_snaps = None
    if trace:
        trace_snaps = [obs.snapshot()]
        with Traced(on_cuda) as traced:
            tw = tr.window(float(mix["trace_seconds"]), keep=False)
        trace_snaps.append(obs.snapshot())
        log(f"traced window {traced.window_s:.3f} s: {tw.completed} "
            f"completed; {len(traced.device)} device activities")
    memory_peak = int(torch.cuda.max_memory_allocated()) if on_cuda else 0

    # the program's state goes before the reference runs
    answers = tr.answers()
    operand = tr.reference_operand()
    tr.release()
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    ref = spec.reference(cfg["workload"])
    dtype = DTYPES[cfg["dtype"]]
    readings = []
    t0 = time.perf_counter()
    for b, x0, x, r in answers:
        b, x0 = b.to(device), x0.to(device)
        x_ref, r_ref = ref.solve(operand, b, x0, cfg["params"], dtype)
        readings.append(judge.gaps(x.to(device), r.to(device), x_ref,
                                   r_ref, b))
    log(f"reference: {len(readings)} answers in "
        f"{time.perf_counter() - t0:.3f} s")
    numbers = judge.worst(readings)
    correct, lines = judge.decide(numbers, limits, w.failed)
    correct = correct and len(readings) >= int(mix["sample"])

    spans = {"plan_s": plan_s, "warm_s": warm_s}
    metrics: Dict[str, dict] = {}
    if not trace:
        for m in spec.end_to_end(name):
            metrics[m["name"]] = {"value": end_to_end(m["name"], w, setup_s),
                                  "unit": m["unit"]}
    else:
        rec = Record(name, cfg, mix, spans, w, traced, snaps, trace_snaps)
        for m in spec.per_layer(name):
            val = spec.reader(m["name"]).read(rec)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_cuda else "cpu",
           "kind": torch.cuda.get_device_name() if on_cuda else "cpu",
           "count": 1, "memory_peak_bytes": memory_peak}
    result = {"correct": bool(correct), "attempted": w.attempted,
              "failed": w.failed, "metrics": metrics, "device": dev}
    if trace:
        busy = traced.busy_s()
        if busy is not None:
            dev["busy_s"] = busy
        dev["window_s"] = traced.window_s
        result["breakdown"] = {"device_ops": traced.top_ops(),
                               "idle_gaps": traced.idle_gaps()}
    result["checks"] = {k: {"value": _finite(numbers[k]),
                            "limit": limits[k]} for k in judge.NUMBERS}
    result["checks"]["answers"] = {"value": len(readings),
                                   "limit": int(mix["sample"])}
    lines.append(f"answers {len(readings)} limit {int(mix['sample'])}")
    return result, lines
