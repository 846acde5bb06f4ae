#!/usr/bin/env python3
"""B7 (``src/repro_torch/csrc/rmsnorm.cu``) against an earlier revision of
its source, on one NVIDIA GPU.

    python3 scripts/b7_vs_parent.py --parent-src OLD/rmsnorm.cu \
        [--pairs 30] [--decode-pairs 6] [--out R.json]

Builds ``OLD/rmsnorm.cu`` with ``nvcc`` into a temporary directory and
calls it through the C interface of the revision before the row groups,
``cello_rmsnorm_{bf16,f32}(x, w, y, rows, d, eps, stream)``, from a copy
of that revision's wrapper (``parent_rmsnorm``: the same checks and host
work).  Then, with ``chip_smoke.py``'s own timers:

1. every B7 case of its phase 3 (``B7_WIDTHS`` at 1024 and 4 rows in fp32
   and bf16, and 4096 x 4096 bf16): both held to the plain version, then
   ``--pairs`` pairs of warm readings (``b7_ms``) and, from 1024 rows, of
   cold ones (``cold_ms`` after a 256 MB read), the order of each pair
   alternating (old, new / new, old); at 4 rows also pairs of eager
   calls (``cuda_ms`` over 200 back-to-back calls: the wrappers' host
   work, which an eager decode step pays at every launch);
2. whole serving paths, the earlier revision swapped in for the model's
   ``rmsnorm``: granite-moe-1b-a400m (d 1024, every layer) and rwkv6-7b
   (d 4096, ``SSM_LAYERS`` layers), each with a fresh serving bundle for
   either revision, ``--decode-pairs`` pairs of the 1 x 1024 prefill, of
   the eager ``greedy_generate`` and of the graphed ``generate`` (one
   CUDA-graph replay a step, captured with that revision), alternating
   as above; wall time per call, ended by a synchronize
   (``--decode-pairs 0`` leaves this part out).

Each case gets the ratio new / old of every pair, their mean, standard
deviation and standard error, and a verdict against ``SLACK`` (3%): met
where the mean plus two standard errors is within it, missed where the
mean less two standard errors is past it, else unresolved.  Exits 1 if a
kernel disagrees with its plain version.
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
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

#: the most the new revision may lose to the earlier one, as a ratio
SLACK = 1.03
#: the serving paths of part 2: (arch, layers (None: all))
PATHS = (("granite-moe-1b-a400m", None), ("rwkv6-7b", "SSM_LAYERS"))


def build_parent(src: str) -> dict:
    """The earlier revision, built: {dtype name: its C entry}."""
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc
    work = tempfile.mkdtemp(prefix="b7_parent_")
    lib = os.path.join(work, "libb7_parent.so")
    cmd = [_nvcc(), *NVCC_FLAGS[:-2], "-shared", src, "-o", lib]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed for {src}:\n{res.stdout}")
    out = ctypes.CDLL(lib)
    vp, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    fns = {}
    for dt, name in (("bfloat16", "cello_rmsnorm_bf16"),
                     ("float32", "cello_rmsnorm_f32")):
        fn = getattr(out, name)
        fn.argtypes = [vp, vp, vp, i32, i32, f64, vp]
        fn.restype = i32
        fns[dt] = fn
    shutil.rmtree(work, ignore_errors=True)       # the library stays mapped
    fns["_lib"] = out
    return fns


def parent_wrapper(fns):
    """The earlier revision's ``kernels.rmsnorm.rmsnorm``, on its build."""
    import torch
    from repro_torch.kernels import count, on_cuda, report_work
    from repro_torch.kernels.build import check
    from repro_torch.kernels.rmsnorm import rmsnorm_plain, work
    calls = [0]

    def parent_rmsnorm(x, w, *, eps=1e-6):
        if not on_cuda(x, w, meta=True):
            return rmsnorm_plain(x, w, eps=eps)
        d = x.shape[-1]
        if x.dtype not in (torch.bfloat16, torch.float32) \
                or w.dtype != torch.float32:
            raise TypeError((x.dtype, w.dtype))
        if w.shape != (d,):
            raise ValueError((w.shape, x.shape))
        if not (x.is_contiguous() and w.is_contiguous()):
            raise ValueError("rmsnorm kernel takes contiguous tensors")
        y = torch.empty_like(x)
        report_work("rmsnorm", *work(x, w))
        if y.is_meta:
            return y
        rows = x.numel() // d if d else 0
        fn = fns["bfloat16" if x.dtype == torch.bfloat16 else "float32"]
        stream = torch.cuda.current_stream(x.device).cuda_stream
        count("rmsnorm")
        calls[0] += 1
        check(fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d,
                 float(eps), stream), "earlier rmsnorm")
        return y
    return parent_rmsnorm, calls


def pairs(new, old, timer, n):
    """``n`` pairs of (new, old) readings by ``timer``, the order of each
    pair alternating, and their ratios' summary."""
    got = {"new": [], "old": []}
    for i in range(n):
        for which in (("old", "new") if i % 2 == 0 else ("new", "old")):
            got[which].append(timer(new if which == "new" else old))
    ratios = [a / b for a, b in zip(got["new"], got["old"])]
    mean = statistics.fmean(ratios)
    sd = statistics.stdev(ratios) if n > 1 else 0.0
    se = sd / n ** 0.5
    verdict = ("met" if mean + 2 * se <= SLACK else
               "missed" if mean - 2 * se > SLACK else "unresolved")
    return dict(new_ms=got["new"], old_ms=got["old"], ratios=ratios,
                new_median_ms=statistics.median(got["new"]),
                old_median_ms=statistics.median(got["old"]),
                ratio_mean=mean, ratio_sd=sd, ratio_se=se,
                ratio_min=min(ratios), ratio_max=max(ratios),
                verdict=verdict)


def _line(label, s):
    return (f"{label}: new {s['new_median_ms']:.5f} ms, old "
            f"{s['old_median_ms']:.5f} ms (medians); new/old "
            f"{s['ratio_mean']:.4f} +- {s['ratio_se']:.4f} (se; sd "
            f"{s['ratio_sd']:.4f}, {s['ratio_min']:.4f}..{s['ratio_max']:.4f}"
            f", {len(s['ratios'])} pairs): {s['verdict']}")


def kernels_part(parent_rmsnorm, n_pairs, records):
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
    flush_buf = torch.ones(64 << 20, device="cuda")       # 256 MB, read
    flush_sum = torch.empty((), device="cuda")

    def flush():
        return torch.sum(flush_buf, 0, out=flush_sum)
    rng = np.random.default_rng(21)
    for d in cs.B7_WIDTHS:
        w = cs._rand(rng, (d,), torch.float32, 0.1)
        both = ("float32", "bfloat16")
        shapes = [(cs.PREFILL_SEQ, both), (cs.GEN_BATCH, both)]
        if d == 4096:
            shapes.append((cs.TRAIN_BATCH * cs.TRAIN_SEQ, ("bfloat16",)))
        for rows, dts in shapes:
            for dt in dts:
                x = cs._rand(rng, (rows, d), getattr(torch, dt))
                want = rmsnorm_plain(x, w)
                cs._hold("rmsnorm", rmsnorm(x, w), want, dt)
                cs._hold("earlier rmsnorm", parent_rmsnorm(x, w), want, dt)

                def new():
                    return rmsnorm(x, w)

                def old():
                    return parent_rmsnorm(x, w)
                rec = dict(case=f"B7 rows={rows} d={d}", dtype=dt,
                           warm=pairs(new, old, cs.b7_ms, n_pairs))
                print(_line(f"{rec['case']} {dt} warm", rec["warm"]),
                      flush=True)
                if rows >= cs.PREFILL_SEQ:
                    rec["cold"] = pairs(new, old,
                                        lambda f: cs.cold_ms(f, flush),
                                        n_pairs)
                    print(_line(f"{rec['case']} {dt} cold", rec["cold"]),
                          flush=True)
                else:
                    rec["eager"] = pairs(new, old, lambda f: cs.cuda_ms(
                        f, reps=200), n_pairs)
                    print(_line(f"{rec['case']} {dt} eager call",
                                rec["eager"]), flush=True)
                records.append(rec)
                del x, want
    del flush_buf


def paths_part(parent_rmsnorm, calls, n_pairs, records):
    import contextlib
    import dataclasses
    import gc
    import numpy as np
    import torch
    import chip_smoke as cs
    import repro_torch.kernels.rmsnorm as rk
    from repro_torch import kernels
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.launch import greedy_generate
    from repro_torch.models import init_params

    @contextlib.contextmanager
    def earlier():
        # the model's RMSNormFn imports kernels.rmsnorm.rmsnorm at each call
        ours = rk.rmsnorm
        rk.rmsnorm = parent_rmsnorm
        try:
            yield
        finally:
            rk.rmsnorm = ours

    def under(fn, old):
        if not old:
            return fn

        def wrapped():
            with earlier():
                return fn()
        return wrapped

    def wall_ms(fn):
        return cs._sync_s(fn)[1] * 1e3

    for arch, layers in PATHS:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=getattr(cs, layers))
        plan = (Session(cfg, device="cuda")
                .trace("prefill", batch=1, seq=cs.PREFILL_SEQ)
                .analyze().codesign().lower())
        p = plan.plan
        assert p.use_fused_rmsnorm, p
        params = init_params(cfg, seed=0, device="cuda")
        rng = np.random.default_rng(0)
        prompt = torch.from_numpy(
            rng.integers(0, cfg.vocab, (1, cs.PREFILL_SEQ))).cuda()
        gen_prompt = torch.from_numpy(rng.integers(
            0, cfg.vocab, (cs.GEN_BATCH, cs.GEN_PROMPT))).cuda()
        steps = cs.GEN_PROMPT + cs.GEN_NEW - 1
        bundles = {"new": plan.serve(), "old": plan.serve()}
        fns = {}
        for which, old in (("new", False), ("old", True)):
            b = bundles[which]
            fns[which] = dict(
                prefill=under(lambda b=b: b.prefill_fn(params, prompt), old),
                eager=under(lambda: greedy_generate(params, cfg, p,
                                                    gen_prompt, cs.GEN_NEW),
                            old),
                graphed=under(lambda b=b: b.generate(params, gen_prompt,
                                                     cs.GEN_NEW), old))
        # warm up each (the graphed bundles capture here) and check that
        # the swap took: the earlier revision runs where swapped in, and
        # B7 nowhere then
        toks = {}
        for which in ("new", "old"):
            kernels.reset_launches()
            before = calls[0]
            for kind in ("prefill", "eager", "graphed"):
                toks[(which, kind)] = fns[which][kind]()
            torch.cuda.synchronize()
            ran_old = calls[0] - before
            assert (ran_old > 0) == (which == "old"), (which, ran_old)
        for which in ("new", "old"):
            assert torch.equal(toks[(which, "eager")],
                               toks[(which, "graphed")]), which
        rec = dict(case=f"{cfg.name} {cfg.n_layers} layers, d "
                   f"{cfg.d_model}", steps=steps,
                   tokens_equal_across_revisions=bool(torch.equal(
                       toks[("new", "eager")], toks[("old", "eager")])))
        for kind, per in (("prefill", 1), ("eager", steps),
                          ("graphed", steps)):
            s = pairs(fns["new"][kind], fns["old"][kind],
                      lambda f, per=per: wall_ms(f) / per, n_pairs)
            rec[kind] = s
            print(_line(f"{rec['case']} {kind}"
                        + (" ms per step" if per > 1 else ""), s),
                  flush=True)
        records.append(rec)
        del params, bundles, fns, toks, plan
        gc.collect()
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-src", required=True)
    ap.add_argument("--pairs", type=int, default=30)
    ap.add_argument("--decode-pairs", type=int, default=6)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("b7_vs_parent: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels.build import cuda_library
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    t0 = time.perf_counter()
    fns = build_parent(args.parent_src)
    cuda_library()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    parent_rmsnorm, calls = parent_wrapper(fns)
    records = []
    bad = None
    try:
        kernels_part(parent_rmsnorm, args.pairs, records)
        if args.decode_pairs:
            paths_part(parent_rmsnorm, calls, args.decode_pairs, records)
    except AssertionError as exc:
        bad = repr(exc)
    summary = dict(card=smi, pairs=args.pairs, decode_pairs=args.decode_pairs,
                   slack=SLACK, failed=bad,
                   verdicts={f"{r['case']} {r.get('dtype', '')} {k}".strip():
                             r[k]["verdict"] for r in records
                             for k in ("warm", "cold", "prefill", "eager",
                                       "graphed") if k in r},
                   seconds=time.perf_counter() - t0)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(summary, records=records), fh, indent=1)
    print(json.dumps(summary))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
