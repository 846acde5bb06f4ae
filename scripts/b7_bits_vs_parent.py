#!/usr/bin/env python3
"""B7 (``src/repro_torch/csrc/rmsnorm.cu``) against an earlier revision of
its source with the same C interface, bit for bit, on one NVIDIA GPU.

    python3 scripts/b7_bits_vs_parent.py --parent-src OLD/rmsnorm.cu \
        [--out R.json]

Builds ``OLD/rmsnorm.cu`` with ``nvcc`` into a temporary directory and
calls its ``cello_rmsnorm_{bf16,f32}(x, w, y, rows, d, g, v, r, vec, eps,
stream)`` with the launch shape that ``kernels.rmsnorm.launch_shape``
gives, beside the port's own ``rmsnorm`` on the same operands, at every
B7 case of ``chip_smoke.py``'s phase 3 that the earlier revision takes:
``B7_WIDTHS`` at 1, 4, 1024 and 4096 rows in fp32 and bf16, d 1001 (the
general path) at 1024 rows, and each width's unaligned view (the general
path on a row map of the vector path's).  Every output must be bitwise
equal; exits 1 where one is not.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def build_parent(src: str) -> dict:
    """The earlier revision, built: {dtype name: its C entry}."""
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc
    work = tempfile.mkdtemp(prefix="b7_bits_")
    lib = os.path.join(work, "libb7_bits.so")
    res = subprocess.run([_nvcc(), *NVCC_FLAGS[:-2], "-shared", src, "-o",
                          lib], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed for {src}:\n{res.stdout}")
    out = ctypes.CDLL(lib)
    vp, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    fns = {"_lib": out}
    for dt, name in (("bfloat16", "cello_rmsnorm_bf16"),
                     ("float32", "cello_rmsnorm_f32")):
        fn = getattr(out, name)
        fn.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, i32, f64, vp]
        fn.restype = i32
        fns[dt] = fn
    shutil.rmtree(work, ignore_errors=True)       # the library stays mapped
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-src", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.build import check
    from repro_torch.kernels.rmsnorm import launch_shape, rmsnorm
    if not torch.cuda.is_available():
        print("b7_bits_vs_parent: CUDA is not available", file=sys.stderr)
        return 2
    fns = build_parent(args.parent_src)
    rng = np.random.default_rng(31)
    eps = 1e-6

    def parent(x, w):
        d = x.shape[-1]
        g, v, r, vec = launch_shape(d, x.dtype)
        y = torch.empty_like(x)
        check(fns[str(x.dtype).split(".")[-1]](
            x.data_ptr(), w.data_ptr(), y.data_ptr(), x.numel() // d, d, g,
            v, r, int(vec), float(eps),
            torch.cuda.current_stream().cuda_stream), "earlier rmsnorm")
        return y
    cases = []
    for d in (*cs.B7_WIDTHS, 1001):
        w = cs._rand(rng, (d,), torch.float32, 0.1)
        for dt in ("float32", "bfloat16"):
            tdt = getattr(torch, dt)
            X = cs._rand(rng, (4096, d), tdt)
            views = [(f"rows={n}", X[:n]) for n in (1, 4, 1024, 4096)]
            buf = torch.empty(1024 * d + 1, dtype=tdt, device="cuda")
            view = buf[1:].view(1024, d)
            view.copy_(X[:1024])
            views.append(("rows=1024 unaligned view", view))
            for what, x in views:
                new, old = rmsnorm(x, w, eps=eps), parent(x, w)
                torch.cuda.synchronize()
                equal = bool(torch.equal(new, old))
                cases.append(dict(d=d, dtype=dt, case=what, bitwise=equal,
                                  launch_shape=list(launch_shape(d, tdt))))
                print(f"d={d} {dt} {what}: "
                      f"{'bitwise equal' if equal else 'DIFFERENT'}",
                      flush=True)
    ok = all(c["bitwise"] for c in cases)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True).stdout.strip()
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(card=smi, parent_src=args.parent_src,
                           cases=cases, all_bitwise=ok), fh, indent=1)
    print(json.dumps({"card": smi, "cases": len(cases), "all_bitwise": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
