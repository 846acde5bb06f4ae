"""Conjugate Gradient through the port's co-designer, end to end, on the card.

The PyTorch/CUDA twin of ``examples/hpc_cg.py``: the same flags, defaults
and printed lines.  Builds the paper's headline HPC workload (skewed
``(n×n)·(n,)`` matvec chains with cross-iteration reuse of the operator
``A``), runs the schedule × buffer co-design, prints the decision
(including the kernel selected per fusion group), then executes the
co-designed schedule through both execution backends of the port — the
``reference`` torch interpreter and ``cuda``, the hand-written Hopper
kernels (B1's generated Triton stream passes; B2/B3 CSR SpMV and B4's
stencil for the workloads that have them) — and validates them against
natural-order evaluation (``repro_torch.frontends.evaluate``).

    PYTHONPATH=src python examples/torch_hpc_cg.py --n 4096 --iters 4
    PYTHONPATH=src python examples/torch_hpc_cg.py --n 256 --device cpu

``--device cuda`` (the default) raises without a card; ``--device cpu``
runs the kernels' plain torch versions.  ``main(argv)`` returns what it
printed as data.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.api import Session
from repro_torch.frontends import evaluate, make_feeds

BACKENDS = ("reference", "cuda")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=4096,
                    help="operator size (n x n); at 4096 the fp64 operator "
                         "is exactly the 128 MiB on-chip capacity")
    ap.add_argument("--iters", type=int, default=4,
                    help="unrolled CG iterations")
    ap.add_argument("--workload", default="cg",
                    help="any registered workload that takes n/iters "
                         "(cg, bicgstab, power_iteration)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; raises without a card) or cpu "
                         "(their plain torch versions)")
    args = ap.parse_args(argv)

    sess = Session(device=args.device)  # arch-less: frontend traces only
    traced = sess.trace(workload=args.workload, n=args.n, iters=args.iters)
    print(f"traced   : {traced}")
    analyzed = traced.analyze()
    print(f"analyzed : {analyzed}")
    designed = analyzed.codesign()
    print(f"codesign : {designed}")
    plan = designed.lower()
    print()
    print(plan.explain())

    # numerical validation: scheduled execution vs natural-order reference,
    # on both execution backends
    feeds = make_feeds(traced.program, seed=0)
    want = evaluate(traced.program, feeds, device=sess.device)
    print()
    out = {"traced": str(traced), "analyzed": str(analyzed),
           "codesign": str(designed), "explain": plan.explain(),
           "max_abs_diff": {}}
    got = None
    for backend in BACKENDS:
        got = plan.run(feeds, backend=backend)
        worst = max(float((got[k] - want[k]).abs().max()) for k in want)
        out["max_abs_diff"][backend] = worst
        print(f"numerical check [{backend:9s}] vs natural-order oracle: "
              f"max abs diff = {worst:.3g} over {sorted(want)}")
    out["outputs"] = {k: v.cpu().numpy() for k, v in got.items()}
    if args.workload == "cg":
        r = out["outputs"][f"r{args.iters}"]
        out["residual_norm"] = float(np.linalg.norm(r))
        print(f"final CG residual norm: {out['residual_norm']:.4g}")
    return out


if __name__ == "__main__":
    main()
