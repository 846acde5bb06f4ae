"""The harness: driven by data, the last line's shape, and what a run must
refuse to do."""
from __future__ import annotations

import json
import math
import subprocess
import sys
import types

import pytest

from bench.harness import guard
from bench.harness.cell import run_cell
from bench.harness.spec import ROOT, Spec

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def check_line(res: dict, trace: bool) -> None:
    keys = list(res)
    assert keys[:5] == KEYS
    assert keys[-1] == "checks"                     # the compared numbers
    assert ("breakdown" in keys) == trace
    json.loads(json.dumps(res))                     # one JSON object
    for name, m in res["metrics"].items():
        assert set(m) == {"value", "unit"}
        assert math.isfinite(m["value"]), name
    for name, c in res["checks"].items():
        assert set(c) == {"value", "limit"}, name
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert "window_s" in dev
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", ["tiny_cg.solve", "tiny_bicg.solve",
                                  "tiny_cg.serve"])
def test_a_cpu_run_is_correct_and_well_formed(tiny_spec, cell):
    res, lines = run_cell(tiny_spec, cell, 2**31 + 17, 0.5, False, "cpu")
    check_line(res, trace=False)
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] > 0
    want = {m["name"] for m in tiny_spec.end_to_end(cell)}
    assert set(res["metrics"]) == want and "setup_s" in want
    assert lines[0].startswith("gap_x ") and " limit " in lines[0]


@pytest.mark.parametrize("cell", ["tiny_cg.solve", "tiny_cg.serve"])
def test_a_traced_cpu_run_reports_per_layer_metrics(tiny_spec, cell):
    res, _ = run_cell(tiny_spec, cell, 5, 0.5, True, "cpu")
    check_line(res, trace=True)
    names = {m["name"] for m in tiny_spec.per_layer(cell)}
    # the device-trace readers find nothing on the CPU and stay silent
    assert {"plan_s", "warm_s"} <= set(res["metrics"]) <= names


def test_new_files_and_entries_alone_add_a_cell_and_a_metric(tiny_root):
    """A configuration, a traffic mix, a limit and a per-layer metric are
    added as files, and entries in BENCHMARK.json: no file of the harness
    changes."""
    b = tiny_root / "bench"
    cfg = json.loads((b / "configs" / "tiny_cg.json").read_text())
    cfg.update(name="tiny_cg8", params=dict(cfg["params"], iters=3))
    (b / "configs" / "tiny_cg8.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "solve.json").read_text())
    mix.update(ahead=1, sample=3)
    (b / "traffic" / "solve_sync.json").write_text(json.dumps(mix))
    (b / "limits" / "tiny_cg8.solve_sync.json").write_text(
        (b / "limits" / "tiny_cg.solve.json").read_text())
    (b / "metrics" / "solves_in_window.py").write_text(
        "def read(rec):\n    return float(rec.window.completed)\n")
    bm = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bm["configs"].append(dict(bm["configs"][0], name="tiny_cg8",
                              file="bench/configs/tiny_cg8.json"))
    bm["workloads"].append({"name": "tiny_cg8.solve_sync",
                            "config": "tiny_cg8", "traffic": "solve_sync",
                            "chips": 1, "why": "a later cell"})
    for m in bm["end_to_end"]:
        if "solve_ms" == m["name"]:
            m["workloads"].append("tiny_cg8.solve_sync")
    bm["per_layer"].append({"name": "solves_in_window", "unit": "req",
                            "better": "higher", "source": "host_clock",
                            "layer": "the whole solve", "moves": "solve_ms",
                            "workloads": ["tiny_cg8.solve_sync"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bm))
    spec = Spec(tiny_root)
    res, _ = run_cell(spec, "tiny_cg8.solve_sync", 8, 0.3, True, "cpu")
    assert res["correct"] is True
    assert res["checks"]["answers"] == {"value": 3, "limit": 3}
    assert res["metrics"]["solves_in_window"]["value"] == res["attempted"]
    res, _ = run_cell(spec, "tiny_cg8.solve_sync", 8, 0.3, False, "cpu")
    assert set(res["metrics"]) == {"solve_ms", "setup_s"}


def test_every_metric_has_its_reader_and_every_cell_its_files():
    spec = Spec()
    for m in spec.bm["per_layer"]:
        assert callable(spec.reader(m["name"]).read)
    for w in spec.bm["workloads"]:
        cfg = spec.config(w["config"])
        assert spec.traffic(w["traffic"])["kind"] in ("solve", "serve")
        assert set(spec.limits(w["name"])) == {"gap_x", "gap_r"}
        spec.operands(cfg["operand"])
        spec.reference(cfg["workload"])
        assert cfg["name"] == w["config"]


def test_without_a_card_the_command_exits_nonzero_and_prints_nothing():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
         "poisson2d_cg.solve", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
        cwd=ROOT)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_a_program_from_elsewhere_is_refused(tmp_path):
    """Beside BENCHMARK.json and the benchmark alone, the program is not the
    checkout's: the run refuses it."""
    with pytest.raises(ImportError):
        guard.check_program_path(tmp_path)
    guard.check_program_path(ROOT)


def test_forbidden_modules_are_named_by_whole_top_level_names(monkeypatch):
    import repro_torch  # noqa: F401 — the port, which is allowed
    assert guard.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("y"))
    assert guard.forbidden_modules() == ["jax", "repro"]


def test_modules_from_the_jax_benchmarks_are_found(monkeypatch):
    mod = types.ModuleType("bench_serve_copy")
    mod.__file__ = str(ROOT / "benchmarks" / "bench_serve.py")
    monkeypatch.setitem(sys.modules, "bench_serve_copy", mod)
    assert guard.benchmarks_files(ROOT) == [mod.__file__]


def test_caches_stay_inside_the_checkout(tmp_path, monkeypatch):
    for key in ("CELLO_TORCH_BUILD_DIR", "TRITON_CACHE_DIR", "TRITON_HOME",
                "CELLO_CACHE_DIR", "CUDA_CACHE_PATH"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(sys, "path", list(sys.path))
    build = guard.prepare_env(tmp_path)
    import os
    for key in ("CELLO_TORCH_BUILD_DIR", "TRITON_CACHE_DIR", "TRITON_HOME",
                "CELLO_CACHE_DIR", "CUDA_CACHE_PATH"):
        assert build in __import__("pathlib").Path(os.environ[key]).parents
