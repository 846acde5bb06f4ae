#!/usr/bin/env python3
"""How far two summation orders part on a Krylov path, by its depth.

    PYTHONPATH=src python3 scripts/krylov_sensitivity.py
        [--workload gmres|bicgstab_sparse] [--depths 2,4,...]

On the CPU, ``make_feeds(seed=0)`` in fp32 and fp64, at each depth (gmres:
``restart`` at n 4096; bicgstab_sparse: ``iters`` on the 5-point
Laplacian at n 2^20): the port's ``cuda`` backend (each kernel's plain
version, which sums in the kernels' orders) against its ``reference``
backend, and the reference computed with the products' operands cut to
TF32 / fp32 (``chip_smoke.lowered_reference``: the control that
``PATH_TOL`` must reject), each as ``chip_smoke._rel_err`` reads it.  A
rounding difference grows by a roughly constant factor a step on these
paths, so the table shows up to which depth an elementwise comparison at
``PATH_TOL`` can tell a correct run from a lower-precision one.  Prints
one JSON line a depth.
"""
import argparse
import json
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

#: workload: (its fixed params, the depth's name, default depths)
PATHS = {
    "gmres": (dict(n=4096), "restart", "2,4,6,8,10,12,16,24,32"),
    "bicgstab_sparse": (dict(n=1 << 20, pattern="laplacian5"), "iters",
                        "4,8,12,16,24,32"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="gmres", choices=sorted(PATHS))
    ap.add_argument("--depths")
    args = ap.parse_args(argv)
    import numpy as np
    import chip_smoke as cs
    from repro_torch.api import Session
    from repro_torch.frontends import feeds_from_numpy, make_feeds
    params, depth, default = PATHS[args.workload]
    sess = Session(device="cpu")
    feeds = {}
    for m in (int(v) for v in (args.depths or default).split(",")):
        traced = sess.trace(workload=args.workload, **params, **{depth: m})
        plan = traced.analyze().codesign().lower(backend="cuda")
        row = {"workload": args.workload, **params, depth: m}
        for dt in ("float32", "float64"):
            if dt not in feeds:     # the leaves do not depend on the depth
                feeds[dt] = make_feeds(traced.program, seed=0,
                                       dtype=getattr(np, dt))
            f = feeds_from_numpy(feeds[dt])
            ref = plan.run(f, backend="reference")
            scale_b = float(np.abs(feeds[dt]["b"]).max())
            row[dt] = {
                "cuda_vs_reference": cs._rel_err(plan.run(f), ref, scale_b),
                "control_vs_reference": cs._rel_err(
                    cs.lowered_reference(plan, f), ref, scale_b),
                "path_tol": cs.PATH_TOL[dt]}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
