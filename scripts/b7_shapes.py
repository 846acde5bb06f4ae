#!/usr/bin/env python3
"""B7's launch shapes (``src/repro_torch/csrc/rmsnorm.cu``), every one
timed, on one NVIDIA GPU.

    python3 scripts/b7_shapes.py [--out R.json]

For each width of ``chip_smoke.py``'s ``B7_WIDTHS`` and d 1001 (the
general path), in bf16 and fp32, at 4, 1024 and 4096 rows: every row
group the C entry ``cello_rmsnorm_{bf16,f32}`` takes (G threads, a
multiple of 32, of V 16-byte vectors, R row groups a CTA of at most 256
threads; on the vector path G·V vectors cover the row exactly, on the
general one with less than a vector a thread of padding), each held to
``rmsnorm_plain`` and then timed warm (``chip_smoke.b7_ms``) and, from
1024 rows, with the L2 emptied (``chip_smoke.cold_ms`` after a 256 MB
read), in two passes over the shapes in opposite order, their mean kept.
Prints, per case, ``kernels.rmsnorm.launch_shape``'s pick beside the
fastest shape warm and cold.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("b7_shapes: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels.build import check, cuda_library
    from repro_torch.kernels.rmsnorm import (MAX_THREADS, VECTORS,
                                             launch_shape, rmsnorm_plain)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    lib = cuda_library()
    flush_buf = torch.ones(64 << 20, device="cuda")       # 256 MB, read
    flush_sum = torch.empty((), device="cuda")

    def flush():
        return torch.sum(flush_buf, 0, out=flush_sum)
    rng = np.random.default_rng(21)
    shapes = []
    for d in (*cs.B7_WIDTHS, 1001):
        w = cs._rand(rng, (d,), torch.float32, 0.1)
        for dt in ("bfloat16", "float32"):
            tdt = getattr(torch, dt)
            per = 16 // tdt.itemsize
            slots = -(-d // per)
            vec = d % per == 0 and launch_shape(d, tdt).vector
            fn = (lib.cello_rmsnorm_bf16 if dt == "bfloat16"
                  else lib.cello_rmsnorm_f32)
            pick = launch_shape(d, tdt)
            for rows in (cs.GEN_BATCH, cs.PREFILL_SEQ,
                         cs.TRAIN_BATCH * cs.TRAIN_SEQ):
                x = cs._rand(rng, (rows, d), tdt)
                want = rmsnorm_plain(x, w)
                for g in range(32, MAX_THREADS + 1, 32):
                    for v in VECTORS:
                        if vec and g * v != slots:
                            continue
                        if not vec and not 0 <= g * v - slots < g:
                            continue
                        # few rows: the C launch takes one row group a CTA
                        for r in ((1,) if rows < 132 else (1, 2, 4, 8)):
                            if g * r > MAX_THREADS:
                                continue
                            y = torch.empty_like(x)

                            def call(x=x, w=w, y=y, rows=rows, d=d, g=g,
                                     v=v, r=r, vec=vec, fn=fn):
                                check(fn(x.data_ptr(), w.data_ptr(),
                                         y.data_ptr(), rows, d, g, v, r,
                                         int(vec), 1e-6, torch.cuda
                                         .current_stream().cuda_stream),
                                      "rmsnorm shape")
                                return y
                            call()
                            torch.cuda.synchronize()
                            cs._hold("rmsnorm shape", y, want, dt)
                            shapes.append(dict(
                                d=d, dtype=dt, rows=rows, vector=vec,
                                shape=(g, v, r), fn=call, warm=[], cold=[],
                                pick=(g, v) == pick[:2]
                                and (rows < 132 or r == pick.rows)))
    print(f"{len(shapes)} shapes", flush=True)
    for order in (1, -1):
        for s in shapes[::order]:
            s["warm"].append(cs.b7_ms(s["fn"]))
            if s["rows"] >= cs.PREFILL_SEQ:
                s["cold"].append(cs.cold_ms(s["fn"], flush))
    cases = {}
    for s in shapes:
        s.pop("fn")
        s["warm_ms"] = sum(s["warm"]) / len(s["warm"])
        s["cold_ms"] = sum(s["cold"]) / len(s["cold"]) if s["cold"] else None
        cases.setdefault((s["d"], s["dtype"], s["rows"]), []).append(s)
    summary = []
    for (d, dt, rows), group in cases.items():
        pick = next(s for s in group if s["pick"])
        line = dict(d=d, dtype=dt, rows=rows, pick=pick["shape"],
                    pick_warm_ms=pick["warm_ms"],
                    pick_cold_ms=pick["cold_ms"])
        for k in ("warm", "cold"):
            if pick[f"{k}_ms"] is not None:
                best = min(group, key=lambda s: s[f"{k}_ms"])
                line[f"best_{k}"] = best["shape"]
                line[f"best_{k}_ms"] = best[f"{k}_ms"]
                line[f"pick_over_best_{k}"] = (pick[f"{k}_ms"]
                                               / best[f"{k}_ms"])
        summary.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(card=smi, summary=summary, shapes=shapes), fh,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
