#!/usr/bin/env python3
"""B2 (``src/repro_torch/csrc/spmv.cu``) in each of its forms and launch
shapes, and the designs tried and not kept (``scripts/b2_variants.cu``),
on one NVIDIA GPU: the timings from which ``launch_b2``'s rule and the
blocks form's constants were chosen.

    python3 scripts/b2_shapes.py [--out R.json] [--reps 3]

Builds a library of ``spmv.cu`` and ``b2_variants.cu`` in one translation
unit with a C entry for each of ``SHAPES`` (the rows form, the warps form
at several shapes, and the variants), beside the form that ``launch_b2``
picks ("library form").  On every operand of
``chip_smoke.py``'s phase 3 (``b2_cases``), in fp32 and fp64, each is
held bitwise against the ordered plain version and timed by CUDA-graph
replay (``reps`` rounds, the shapes in turns, reversed every other round;
the median), beside cuSPARSE (``torch.mv`` on a CSR tensor) and the gather
floor (``chip_smoke.floors``).  Exits 1 where a result differs.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import warnings

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

#: (kind, template arguments after the dtype): "blocks" the kept form,
#: ``launch_b2_blocks<T, warps, chunks, E>`` (steps of 32 chunks entries);
#: the rest ``b2_variants.cu``'s: "staged" <threads, window, E>, "direct"
#: <threads, window, E, min CTAs an SM, fold lookahead (0: vectors)>,
#: "warpsx" <warps, chunks, E, stream hint, vector fold>, "piped" <warps,
#: chunks, E>, "cluster" <CTAs a cluster, warps, chunks, E>
SHAPES = (("blocks", 8, 2, 8192), ("blocks", 8, 4, 8192), ("blocks", 8, 1, 8192),
          ("blocks", 8, 8, 8192), ("blocks", 8, 2, 4096), ("blocks", 8, 4, 4096),
          ("blocks", 4, 2, 4096), ("blocks", 16, 2, 8192),
          ("blocks", 8, 8, 16384),
          ("staged", 256, 1024, 4096), ("staged", 512, 1024, 4096),
          ("staged", 256, 512, 4096), ("staged", 256, 1024, 8192),
          ("direct", 256, 1024, 4096, 1, 8), ("direct", 512, 1024, 4096, 1, 8),
          ("direct", 128, 512, 4096, 1, 8), ("direct", 256, 1024, 4096, 8, 8),
          ("direct", 256, 1024, 4096, 6, 4), ("direct", 256, 1024, 4096, 1, 0),
          ("warpsx", 8, 2, 8192, 0, 0), ("warpsx", 8, 2, 8192, 2, 0),
          ("warpsx", 8, 2, 8192, 1, 1), ("piped", 8, 2, 8192),
          ("piped", 8, 4, 8192), ("cluster", 4, 32, 2, 4096),
          ("cluster", 8, 32, 2, 4096), ("cluster", 8, 16, 2, 4096))
LAUNCH = {"blocks": "launch_b2_blocks", "staged": "launch_b2x_staged",
          "direct": "launch_b2x_direct", "warpsx": "launch_b2x_warps",
          "piped": "launch_b2x_piped", "cluster": "launch_b2x_cluster"}


def _name(kind, *args):
    return "_".join(str(v) for v in (kind, *args))


def build_variants() -> ctypes.CDLL:
    """``spmv.cu`` and ``b2_variants.cu`` with entries ``b2v_rows_*`` and
    ``b2v_<kind>_<arguments>_*``."""
    from repro_torch.kernels.build import CSRC, NVCC_FLAGS, _nvcc
    here = os.path.dirname(os.path.abspath(__file__))
    lines = [f'#include "{CSRC / "spmv.cu"}"',
             f'#include "{os.path.join(here, "b2_variants.cu")}"']
    sig = ("(const void* p, const void* i, const void* d, const void* x, "
           "void* y, int rows, int entries, void* s)")
    for t, name in (("float", "f32"), ("double", "f64")):
        lines.append(f'extern "C" int b2v_rows_{name}{sig} {{ return '
                     f'launch_b2_rows<{t}>(p, i, d, x, y, rows, s); }}')
        for kind, *shape in SHAPES:
            lines.append(
                f'extern "C" int b2v_{_name(kind, *shape)}_{name}{sig} '
                f'{{ return {LAUNCH[kind]}<{t}, '
                f'{", ".join(str(v) for v in shape)}>(p, i, d, x, y, rows, '
                f'entries, s); }}')
    work = tempfile.mkdtemp(prefix="b2_shapes_")
    src = os.path.join(work, "variants.cu")
    with open(src, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    lib = os.path.join(work, "libb2_variants.so")
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", src, "-o", lib],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed for the variants:\n{res.stdout}")
    for line in res.stdout.splitlines():
        if "csr_spmv" in line or "registers" in line:
            print(f"ptxas: {line.strip()}", flush=True)
    out = ctypes.CDLL(lib)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("rows", *(_name(*v) for v in SHAPES)):
        for sfx in ("f32", "f64"):
            fn = getattr(out, f"b2v_{name}_{sfx}")
            fn.argtypes = [vp, vp, vp, vp, vp, i32, i32, vp]
            fn.restype = i32
    return out


def replay_ms(graphs, rounds):
    """{name: median ms a call} of captured graphs, replayed in turns,
    the order reversed every other round."""
    import torch
    names = list(graphs)
    got = {k: [] for k in names}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for r in range(rounds):
        for k in (names if r % 2 == 0 else names[::-1]):
            graph, inner = graphs[k]
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            got[k].append(start.elapsed_time(end) / inner)
    return {k: statistics.median(v) for k, v in got.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.frontends.sparse import _components
    from repro_torch.kernels.build import KernelError, check
    from repro_torch.kernels.spmv import (spmv, spmv_shape,
                                          spmv_sliced_plain)
    if not torch.cuda.is_available():
        print("b2_shapes: CUDA is not available", file=sys.stderr)
        return 2
    cs.CARD = cs.smi_line()
    started = cs.start_floors()
    lib = build_variants()
    _empty, gather = cs.floors(started)
    comps = [_components(*k, 0, "A") for k in (
        ("laplacian5", 1 << 20, None, None), ("random", 131072, 1e-3, None),
        ("banded", cs.OB_N, None, cs.OB_BANDWIDTH))]
    csr = [tuple(c[k] for k in ("indptr", "indices", "data")) for c in comps]
    cases = cs.b2_cases(*csr, cs.b3_patterns(csr[0]))
    rows_out, ok = [], True
    for label, (indptr_np, indices_np, data_np), _cold in cases:
        n, nnz = indptr_np.shape[0] - 1, indices_np.shape[0]
        indptr = torch.from_numpy(indptr_np).cuda()
        indices = torch.from_numpy(indices_np).cuda()
        for dt in ("float32", "float64"):
            tdt = getattr(torch, dt)
            sfx = "f32" if dt == "float32" else "f64"
            data = torch.from_numpy(data_np).to("cuda", tdt)
            x = torch.from_numpy(np.random.default_rng(5).standard_normal(
                n)).to("cuda", tdt)
            want = spmv_sliced_plain(indptr, indices, data, x, n, 0)
            fns = {"library form": lambda: spmv(indptr, indices, data, x, n)}
            for name in ("rows", *(_name(*v) for v in SHAPES)):
                fn = getattr(lib, f"b2v_{name}_{sfx}")

                def call(fn=fn, y=torch.empty_like(want)):
                    check(fn(indptr.data_ptr(), indices.data_ptr(),
                             data.data_ptr(), x.data_ptr(), y.data_ptr(), n,
                             nnz, torch.cuda.current_stream().cuda_stream),
                          "b2 variant")
                    return y
                fns[name] = call
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                A = torch.sparse_csr_tensor(indptr, indices, data, (n, n))
            bitwise = {}
            for name, fn in list(fns.items()):
                try:
                    got = fn()
                except KernelError as e:      # a shape this operand refuses
                    print(f"{label} {dt} {name}: {e}", flush=True)
                    del fns[name]
                    continue
                torch.cuda.synchronize()
                bitwise[name] = bool(torch.equal(got, want))
                ok &= bitwise[name]
            fns["cuSPARSE"] = lambda: torch.mv(A, x)
            fns["gather hashed"] = lambda: gather(x, nnz)
            fns["gather at indices"] = lambda: gather(x, nnz, indices)
            inner = 10
            graphs = {k: (cs._captured(fn, inner), inner)
                      for k, fn in fns.items()}
            ms = replay_ms(graphs, 2 * args.reps)
            es = data.element_size()
            bound = (4 * (n + 1) + (4 + es) * nnz + 2 * es * n) \
                / cs.PEAK_BYTES_S * 1e3
            rec = dict(case=label, n=n, nnz=nnz, dtype=dt, card=cs.CARD,
                       bound_ms=bound, form=spmv_shape(n, nnz), ms=ms,
                       bitwise=bitwise)
            rows_out.append(rec)
            print(json.dumps(rec), flush=True)
            del graphs
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(dict(card=cs.CARD, shapes=SHAPES, cases=rows_out,
                           all_bitwise=ok), fh, indent=1)
    print(json.dumps({"card": cs.CARD, "cases": len(rows_out),
                      "all_bitwise": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
