#!/usr/bin/env python3
"""B2 (``src/repro_torch/csrc/spmv.cu``) against an earlier revision of
its source, bit for bit and in time, on one NVIDIA GPU.

    python3 scripts/b2_vs_parent.py --parent-src OLD/spmv.cu [--pairs 30]
        [--out R.json]

Builds ``OLD/spmv.cu`` with ``nvcc`` into a temporary directory and calls
its ``cello_spmv_{f32,f64}(indptr, indices, data, x, y, rows, stream)``
(the one-thread-a-row B2 before the blocks form), beside the port's own
``spmv`` on the same operands: every B2 operand of ``chip_smoke.py``'s
phase 3 (``b2_cases``: the 5-point Laplacian, the random pattern, the
banded operand, the random pattern with empty rows, the skewed one), in
fp32 and fp64.  Every output must be bitwise equal (exits 1 where one is
not).  Each kernel is captured in a CUDA graph of 10 calls and the two
graphs are replayed in ``pairs`` alternating pairs (new, old, then old,
new); the median, the spread (lowest to highest) and new / old are
printed.  On cases that ``b2_cases`` times cold, 5 pairs more with the L2
emptied before each call (``chip_smoke.cold_ms``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def build_parent(src: str) -> dict:
    """The earlier revision, built: {dtype name: its C entry}."""
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc
    work = tempfile.mkdtemp(prefix="b2_parent_")
    lib = os.path.join(work, "libb2_parent.so")
    res = subprocess.run([_nvcc(), *NVCC_FLAGS[:-2], "-shared", src, "-o",
                          lib], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed for {src}:\n{res.stdout}")
    out = ctypes.CDLL(lib)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fns = {"_lib": out}
    for dt, name in (("float32", "cello_spmv_f32"),
                     ("float64", "cello_spmv_f64")):
        fn = getattr(out, name)
        fn.argtypes = [vp, vp, vp, vp, vp, i32, vp]
        fn.restype = i32
        fns[dt] = fn
    shutil.rmtree(work, ignore_errors=True)       # the library stays mapped
    return fns


def pairs_ms(new, old, pairs):
    """([new ms], [old ms]) a call, the two captured graphs of 10 calls
    replayed in ``pairs`` alternating pairs."""
    import torch
    import chip_smoke as cs
    inner = 10
    graphs = {"new": cs._captured(new, inner), "old": cs._captured(old,
                                                                    inner)}
    got = {"new": [], "old": []}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for p in range(pairs):
        for k in (("new", "old") if p % 2 == 0 else ("old", "new")):
            start.record()
            graphs[k].replay()
            end.record()
            torch.cuda.synchronize()
            got[k].append(start.elapsed_time(end) / inner)
    return got["new"], got["old"]


def _summary(v):
    return dict(median=statistics.median(v), low=min(v), high=max(v))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-src", required=True)
    ap.add_argument("--pairs", type=int, default=30)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.frontends.sparse import _components
    from repro_torch.kernels.build import check
    from repro_torch.kernels.spmv import spmv, spmv_shape
    if not torch.cuda.is_available():
        print("b2_vs_parent: CUDA is not available", file=sys.stderr)
        return 2
    cs.CARD = cs.smi_line()
    fns = build_parent(args.parent_src)
    comps = [_components(*k, 0, "A") for k in (
        ("laplacian5", 1 << 20, None, None), ("random", 131072, 1e-3, None),
        ("banded", cs.OB_N, None, cs.OB_BANDWIDTH))]
    csr = [tuple(c[k] for k in ("indptr", "indices", "data")) for c in comps]
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    cases = []
    for label, (indptr_np, indices_np, data_np), cold in cs.b2_cases(
            *csr, cs.b3_patterns(csr[0])):
        n, nnz = indptr_np.shape[0] - 1, indices_np.shape[0]
        indptr = torch.from_numpy(indptr_np).cuda()
        indices = torch.from_numpy(indices_np).cuda()
        for dt in ("float32", "float64"):
            tdt = getattr(torch, dt)
            data = torch.from_numpy(data_np).to("cuda", tdt)
            x = torch.from_numpy(np.random.default_rng(5).standard_normal(
                n)).to("cuda", tdt)
            y_old = torch.empty(n, dtype=tdt, device="cuda")

            def new():
                return spmv(indptr, indices, data, x, n)

            def old():
                check(fns[dt](indptr.data_ptr(), indices.data_ptr(),
                              data.data_ptr(), x.data_ptr(), y_old.data_ptr(),
                              n, torch.cuda.current_stream().cuda_stream),
                      "earlier spmv")
                return y_old
            a, b = new(), old()
            torch.cuda.synchronize()
            equal = bool(torch.equal(a, b))
            t_new, t_old = pairs_ms(new, old, args.pairs)
            rec = dict(case=label, n=n, nnz=nnz, dtype=dt, card=cs.CARD,
                       form=spmv_shape(n, nnz)["form"], bitwise=equal,
                       new_ms=_summary(t_new), old_ms=_summary(t_old),
                       ratio=statistics.median(t_new)
                       / statistics.median(t_old))
            if cold:
                cn, co = [], []
                for p in range(5):
                    for which in ((new, cn), (old, co)) if p % 2 == 0 else (
                            (old, co), (new, cn)):
                        which[1].append(cs.cold_ms(
                            which[0], lambda: flush.fill_(1.0)))
                rec.update(new_cold_ms=_summary(cn), old_cold_ms=_summary(co),
                           cold_ratio=statistics.median(cn)
                           / statistics.median(co))
            cases.append(rec)
            print(json.dumps(rec), flush=True)
    ok = all(c["bitwise"] for c in cases)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(dict(card=cs.CARD, parent_src=args.parent_src,
                           pairs=args.pairs, cases=cases, all_bitwise=ok),
                      fh, indent=1)
    print(json.dumps({"card": cs.CARD, "cases": len(cases),
                      "all_bitwise": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
