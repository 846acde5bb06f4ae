#!/usr/bin/env python3
"""B6 (``src/repro_torch/csrc/fused_mlp.cu``) against an earlier revision of
its source, on one NVIDIA GPU.

    python3 scripts/b6_vs_parent.py --parent-src OLD/fused_mlp.cu \
        [--out R.json]

Builds ``OLD/fused_mlp.cu`` with ``nvcc`` into a temporary directory and
calls it through the C interface ``cello_fused_mlp_{bf16,f32}(x, wg, wu,
wd, scratch, out, m, d, f, chunk, block_m, act, stream)``, giving it the
scratch of a design that kept every chunk's part (an ``(n_chunks, M, D)``
fp32 partial, the most any revision takes), beside the port's
``kernels.fused_mlp.fused_mlp`` on the same inputs, at every B6 shape and
dtype that ``chip_smoke.py``'s phase 3 holds.  For each case it checks
that the two outputs are bitwise equal and that a second call and a
CUDA-graph replay of the port's kernel repeat its output bitwise, and
records both kernels' device times (CUDA-graph replays of 10 calls, taken
old, new, new, old) and the bytes each call allocates beside its output.
Exits 1 if any case differs.
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
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

#: (name, rows, D, F, gated, activation, dtypes): phase 3's B6 cases
#: (``check_mlp``, ``check_mlp_recurrent``, ``check_mlp_families``)
CASES = (
    ("granite gated silu", 1024, 4096, 12800, True, "silu",
     ("float32", "bfloat16")),
    ("granite gated silu", 4, 4096, 12800, True, "silu",
     ("float32", "bfloat16")),
    ("granite gated silu (training rows)", 4096, 4096, 12800, True, "silu",
     ("bfloat16",)),
    ("relu2 no gate", 300, 4096, 1000, False, "relu2",
     ("float32", "bfloat16")),
    ("gelu gated, ragged M and F", 77, 4096, 1000, True, "gelu",
     ("float32", "bfloat16")),
    ("silu gated, 7 rows (16-row pad)", 7, 4096, 1000, True, "silu",
     ("float32", "bfloat16")),
    ("recurrentgemma gated gelu", 4096, 2560, 7680, True, "gelu",
     ("float32", "bfloat16")),
    ("rwkv6 relu2", 1024, 4096, 14336, False, "relu2",
     ("float32", "bfloat16")),
    ("hubert gelu", 1024, 1280, 5120, False, "gelu",
     ("float32", "bfloat16")),
    ("llama-vision gated silu", 1024, 4096, 14336, True, "silu",
     ("float32", "bfloat16")),
    ("llama-vision gated silu", 4, 4096, 14336, True, "silu",
     ("float32", "bfloat16")),
)
ACT = {"silu": 0, "gelu": 1, "relu2": 2}


def build_parent(src: str) -> ctypes.CDLL:
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc
    work = tempfile.mkdtemp(prefix="b6_parent_")
    lib = os.path.join(work, "libb6_parent.so")
    cmd = [_nvcc(), *NVCC_FLAGS[:-2], "-shared", src, "-o", lib]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed for {src}:\n{res.stdout}")
    out = ctypes.CDLL(lib)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("cello_fused_mlp_bf16", "cello_fused_mlp_f32"):
        fn = getattr(out, name)
        fn.argtypes = [vp] * 6 + [i32] * 6 + [vp]
        fn.restype = i32
    shutil.rmtree(work, ignore_errors=True)       # the library stays mapped
    return out


def graph_ms(fn, inner: int = 10, reps: int = 5) -> float:
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * inner)


def scratch_bytes(fn, out_bytes: int) -> int:
    """Bytes one call allocates at its peak beside its output."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak - out_bytes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-src", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("b6_vs_parent: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels.fused_mlp import fused_mlp, launch_shape
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    t0 = time.perf_counter()
    parent = build_parent(args.parent_src)
    print(f"parent built in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(23)
    records, bad = [], []
    for name, m, d, f, gated, act, dtypes in CASES:
        def rand(shape, scale, dtype=torch.float32):
            return (torch.from_numpy(rng.standard_normal(shape,
                                                         dtype="float32"))
                    .mul_(scale).to("cuda", dtype))
        wg = rand((d, f), d ** -0.5) if gated else None
        wu = rand((d, f), d ** -0.5)
        wd = rand((f, d), f ** -0.5)
        for dt in dtypes:
            x = rand((m, d), 1.0, getattr(torch, dt))

            def new():
                return fused_mlp(x, wg, wu, wd, activation=act)

            def old():
                block_m, chunk = launch_shape(m, f)
                partial = torch.empty((-(-f // chunk), m, d),
                                      dtype=torch.float32, device="cuda")
                out = torch.empty_like(x)
                fn = (parent.cello_fused_mlp_bf16 if dt == "bfloat16"
                      else parent.cello_fused_mlp_f32)
                err = fn(x.data_ptr(), None if wg is None else wg.data_ptr(),
                         wu.data_ptr(), wd.data_ptr(), partial.data_ptr(),
                         out.data_ptr(), m, d, f, chunk, block_m, ACT[act],
                         torch.cuda.current_stream().cuda_stream)
                assert err == 0, ("parent launch", err)
                return out
            a, b = new(), old()
            again = new()
            torch.cuda.synchronize()
            same = torch.equal(a.view(torch.int16 if dt == "bfloat16"
                                      else torch.int32),
                               b.view(torch.int16 if dt == "bfloat16"
                                      else torch.int32))
            repeat = torch.equal(a, again)
            # a replay of the captured call repeats the eager output
            static = {}
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                new()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                static["out"] = new()
            for _ in range(3):
                graph.replay()
            torch.cuda.synchronize()
            replay = torch.equal(static["out"], a)
            del graph, static
            times = {"old": [], "new": []}
            for which in ("old", "new", "new", "old"):
                times[which].append(graph_ms(old if which == "old" else new))
            out_bytes = x.numel() * x.element_size()
            rec = dict(case=f"{name} M={m} D={d} F={f}", dtype=dt,
                       bitwise_vs_parent=same, repeats_bitwise=repeat,
                       replay_bitwise=replay,
                       max_abs_diff=float((a.double() - b.double()).abs()
                                          .max()),
                       new_ms=times["new"], parent_ms=times["old"],
                       new_scratch_bytes=scratch_bytes(new, out_bytes),
                       parent_scratch_bytes=scratch_bytes(old, out_bytes),
                       card=smi)
            records.append(rec)
            print(json.dumps(rec), flush=True)
            if not (same and repeat and replay):
                bad.append(rec["case"] + " " + dt)
            del a, b, again, x
        del wg, wu, wd
        torch.cuda.empty_cache()
    summary = dict(card=smi, cases=len(records), differing=bad,
                   seconds=time.perf_counter() - t0)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(summary, records=records), fh, indent=1)
    print(json.dumps(summary))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
