"""The control of a cell's comparison, on the card.

    python3 bench/control.py --workload <cell> --seeds 1 2 3 --seconds 3
    python3 bench/control.py --workload <cell> --seeds 1 ... 12 --sound

Runs the cell as ``run.py`` does, with the program fed one precision below
the one the configuration states (float32 for float64: the program's own
float32 path), and the answers still held against the reference in the
configuration's precision.  Prints, a seed, each compared number beside
its limit: a sound limit fails the control on every seed.  With
``--sound`` the program runs as the configuration states, and the
readings are the lower ends of the limits.  The benchmark's own runs never
run this.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: the nearest precision below the one a configuration states
LOWER = {"float64": "float32"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--sound", action="store_true",
                    help="run the program in the configuration's precision")
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from bench.harness import guard
    guard.prepare_env(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from bench.harness.cell import run_cell
    from bench.harness.spec import Spec
    spec = Spec(ROOT)
    stated = spec.config(spec.cell(args.workload)["config"])["dtype"]
    run_dtype = stated if args.sound else LOWER[stated]
    verdicts = []
    for seed in args.seeds:
        res, lines = run_cell(spec, args.workload, seed, args.seconds,
                              False, "cuda", run_dtype=run_dtype)
        print(json.dumps({"seed": seed, "precision": run_dtype,
                          "correct": res["correct"],
                          "checks": res["checks"]}), flush=True)
        verdicts.append(res["correct"])
    if args.sound:
        print(f"correct on every seed: {all(verdicts)}", flush=True)
        return 0 if all(verdicts) else 1
    print(f"control fails every seed: {not any(verdicts)}", flush=True)
    return 0 if not any(verdicts) else 1


if __name__ == "__main__":
    sys.exit(main())
