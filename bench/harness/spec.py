"""Find a cell's pieces by the names ``BENCHMARK.json`` gives them.

Every piece that belongs to one configuration, traffic mix, pattern,
workload or per-layer metric sits in a file of its own under the benchmark's
folder, so a later cell or metric is added by adding files:

* ``configs/<config>.json`` (the file ``BENCHMARK.json`` names);
* ``traffic/<mix>.json``, read by ``harness.traffic``;
* ``limits/<cell>.json``, the limits of the numbers ``judge`` compares;
* ``operands/<operand>.py``, a CSR generator with ``make(cfg, ...)``
  (the configuration's ``operand``);
* ``reference/<workload>.py``, a plain solver with ``solve``;
* ``metrics/<metric>.py``, a reader with ``read(rec)``.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
from types import ModuleType
from typing import Dict, List

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _load_py(path: pathlib.Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """``BENCHMARK.json`` and the benchmark's folder under ``root``."""

    def __init__(self, root: pathlib.Path = ROOT):
        self.root = pathlib.Path(root)
        self.dir = self.root / "bench"
        self.bm = json.loads((self.root / "BENCHMARK.json").read_text())

    # -- entries of BENCHMARK.json -------------------------------------
    def cell(self, name: str) -> dict:
        for w in self.bm["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in self.bm['workloads']]}")

    def config(self, name: str) -> dict:
        for c in self.bm["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def _applies(self, metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.bm["end_to_end"] if self._applies(m, cell)]

    def per_layer(self, cell: str) -> List[dict]:
        """Per-layer metrics that read something in ``cell``: listed for
        it, or listed for no cell and moving an end-to-end metric that the
        cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.bm["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    # -- files under the folder ----------------------------------------
    def traffic(self, mix: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{mix}.json").read_text())

    def limits(self, cell: str) -> Dict[str, float]:
        return json.loads((self.dir / "limits" / f"{cell}.json")
                          .read_text())["limits"]

    def operands(self, operand: str) -> ModuleType:
        return _load_py(self.dir / "operands" / f"{operand}.py",
                        f"bench_operands_{operand}")

    def reference(self, workload: str) -> ModuleType:
        return _load_py(self.dir / "reference" / f"{workload}.py",
                        f"bench_reference_{workload}")

    def reader(self, metric: str) -> ModuleType:
        return _load_py(self.dir / "metrics" / f"{metric}.py",
                        "bench_metric_" + metric.replace(".", "__"))
