"""Fixtures of the benchmark's own tests: the repo root on ``sys.path`` (the
benchmark is the package ``bench``) and a copy of the benchmark with small
cells that a CPU run can hold."""
from __future__ import annotations

import json
import pathlib
import shutil
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: small cells beside each real one: (name, config, traffic, real cell)
TINY = (("tiny_cg.solve", "tiny_cg", "solve", "poisson2d_cg.solve"),
        ("tiny_bicg.solve", "tiny_bicg", "solve", "hpcg27_bicgstab.solve"),
        ("tiny_cg.serve", "tiny_cg", "serve", "poisson2d_cg.serve"))

#: the metrics of a served cell, which ``BENCHMARK.json`` holds no cell for
#: yet: entries that a served cell brings with it (the readers are under
#: ``metrics/``), given here to the small served cell alone
SERVED = (
    ("end_to_end", {"name": "served_rps", "unit": "req/s",
                    "better": "higher", "bound": 0.25,
                    "source": "host_clock"}),
    ("end_to_end", {"name": "served_p95_ms", "unit": "ms", "better": "lower",
                    "bound": 0.25, "source": "host_clock"}),
    ("per_layer", {"name": "serve_queue_wait_ms", "unit": "ms",
                   "better": "lower", "source": "program_span",
                   "layer": "solver serving", "moves": "served_p95_ms"}),
    ("per_layer", {"name": "serve_batch_lanes", "unit": "req",
                   "better": "higher", "source": "program_counter",
                   "layer": "solver serving", "moves": "served_rps"}),
    ("per_layer", {"name": "b2_lanes_roofline", "unit": "%",
                   "better": "higher", "source": "device_trace",
                   "layer": "B2 lanes", "moves": "served_rps"}),
    ("per_layer", {"name": "device_idle.serve", "unit": "%",
                   "better": "lower", "source": "device_trace",
                   "layer": "device", "moves": "served_rps"}),
    ("per_layer", {"name": "serve_mfu", "unit": "%", "better": "higher",
                   "source": "host_clock", "layer": "the whole solve",
                   "moves": "served_rps"}))


def make_tiny_root(dest: pathlib.Path) -> pathlib.Path:
    """A copy of ``BENCHMARK.json`` and ``bench/`` under ``dest`` with three
    small cells added as a later change would add them: files and entries
    only.  Each takes the metrics of the real cell it shrinks (the served
    one those in ``SERVED``), and limits that hold the program's readings
    at these sizes apart from the float32 control's (about 1e-16 against
    1e-7)."""
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bm = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfgs = dest / "bench" / "configs"
    small = {"tiny_cg": ("poisson2d_cg", {"n": 16 * 16, "iters": 8}, {}),
             "tiny_bicg": ("hpcg27_bicgstab",
                           {"n": 120, "iters": 6, "density": 27 / 120},
                           {"grid": [6, 5, 4]})}
    for name, (base, params, keys) in small.items():
        cfg = json.loads((cfgs / f"{base}.json").read_text())
        cfg["name"] = name
        cfg["params"].update(params)
        cfg.update(keys)
        (cfgs / f"{name}.json").write_text(json.dumps(cfg))
        entry = dict(next(c for c in bm["configs"] if c["name"] == base))
        entry.update(name=name, file=f"bench/configs/{name}.json")
        bm["configs"].append(entry)
    for name, cfg, traffic, real in TINY:
        bm["workloads"].append({"name": name, "config": cfg,
                                "traffic": traffic, "chips": 1,
                                "why": f"{real} at a CPU test's size"})
        for m in bm["end_to_end"] + bm["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(name)
        (dest / "bench" / "limits" / f"{name}.json").write_text(json.dumps(
            {"limits": {"gap_x": 1e-10, "gap_r": 1e-10}}))
    for key, m in SERVED:
        bm[key].append(dict(m, workloads=["tiny_cg.serve"]))
    for m in bm["per_layer"]:           # set-up's layers are every cell's
        if m["moves"] == "setup_s" and "workloads" in m:
            m["workloads"].append("tiny_cg.serve")
    (dest / "BENCHMARK.json").write_text(json.dumps(bm, indent=1))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


@pytest.fixture
def tiny_spec(tiny_root):
    from bench.harness.spec import Spec
    return Spec(tiny_root)
