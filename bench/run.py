"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process is one run of one cell of ``BENCHMARK.json``: set-up (the
operand and right-hand sides made on the card from the seed, the plan,
every kernel and graph the traffic will use), then ``--seconds`` of
measured traffic, then (``--trace 1``) a shorter window under
``torch.profiler``, then the comparison of a sample of the answers with
the plain reference.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each compared number
beside its limit, which also close standard error).  With ``--trace 0``
the metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics.

The run exits with a code other than 0, and prints no result, without a
CUDA device (or with fewer than the cell asks for), when the program is not
the checkout's ``src/repro_torch``, and when after the window the process
holds a module of JAX or of the JAX package (``repro``), or one loaded from
``benchmarks/``.  Every cache the program builds lies under ``build/`` of
the checkout (``harness.guard``).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from bench.harness import guard
    guard.prepare_env(ROOT)
    from bench.harness.spec import Spec
    spec = Spec(ROOT)
    cell = spec.cell(args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"no run: the cell needs {cell['chips']} CUDA device(s), "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    guard.check_program_path(ROOT)
    from bench.harness.cell import log, run_cell
    result, lines = run_cell(spec, args.workload, args.seed, args.seconds,
                             bool(args.trace), device="cuda")
    bad = guard.forbidden_modules()
    files = guard.benchmarks_files(ROOT)
    if bad or files:
        log(f"no result: the run loaded {bad} {files}")
        return 3
    print(json.dumps(result), flush=True)
    for line in lines:
        log(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
