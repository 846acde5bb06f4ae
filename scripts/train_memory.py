#!/usr/bin/env python3
"""Where a training step's memory peaks, on one NVIDIA GPU.

    python3 scripts/train_memory.py [--arch granite-3-8b] [--layers 8]
                                    [--batch 4] [--seq 1024] [--out R.json]

One step of ``chip_smoke.py``'s phase 11 (``value_and_grad`` of the
plan's loss, the forward and the backward apart), with and without the
plan's remat policy, on random weights.  A hook on every weight records
the bytes allocated, and the peak so far, when its gradient is formed:
the backward forms them from the lm head back to the embedding, so the
record shows whether the step's peak falls while activations are still
held (early) or once the gradients are (late), and what, beyond the
gradients, is alive there.  Every figure is bytes above the resident
weights; the card's name and power limit head the output.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    import torch.utils._pytree as pytree
    if not torch.cuda.is_available():
        print("train_memory: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.launch.train import TrainConfig, make_loss_fn, stub_inputs
    from repro_torch.models import init_params
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    cfg = dataclasses.replace(get_config(args.arch), n_layers=args.layers)
    plan = Session(cfg, device="cuda").default_plan(seq=args.seq).plan
    params = init_params(cfg, seed=0, device="cuda")
    x, y = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                      global_batch=args.batch)).batch_at(0)
    batch = {"tokens": torch.from_numpy(x).cuda(),
             "labels": torch.from_numpy(y).cuda(),
             **stub_inputs(cfg, args.batch, args.seq, 0, "cuda")}
    flat, spec = pytree.tree_flatten_with_path(params)
    names = [pytree.keystr(p) for p, _ in flat]
    leaves = [t for _, t in flat]
    grad_bytes = sum(t.numel() * 4 for t in leaves)
    out = {"card": smi, "arch": cfg.name, "layers": cfg.n_layers,
           "batch": args.batch, "seq": args.seq, "grad_bytes": grad_bytes}
    for remat in (True, False):
        loss_fn = make_loss_fn(cfg, plan, TrainConfig(remat=remat))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        alias = [t.detach().requires_grad_(True) for t in leaves]
        events = []

        def hook(name):
            def fn(grad):
                events.append((name, torch.cuda.memory_allocated() - base,
                               torch.cuda.max_memory_allocated() - base))
            return fn
        for name, a in zip(names, alias):
            a.register_hook(hook(name))
        loss = loss_fn(pytree.tree_unflatten(alias, spec), batch)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        fwd_peak = torch.cuda.max_memory_allocated() - base
        grads = torch.autograd.grad(loss, alias, materialize_grads=True)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        end = torch.cuda.memory_allocated() - base
        # the first gradient formed once the peak stood at its last value
        at = next((n for n, _, p in events if p == peak), "after the backward")
        rec = dict(held=held, fwd_peak=fwd_peak, peak=peak,
                   end_of_backward=end, peak_reached_at=at,
                   timeline=[dict(leaf=n, allocated=a, peak_so_far=p)
                             for n, a, p in events])
        out["remat" if remat else "no_remat"] = rec
        gb = 1e9
        print(f"remat={remat}: held {held / gb:.3f} GB, forward peak "
              f"{fwd_peak / gb:.3f}, step peak {peak / gb:.3f} (gradients "
              f"{grad_bytes / gb:.3f}), allocated after the backward "
              f"{end / gb:.3f}; the peak reached by the time {at} had its "
              f"gradient", flush=True)
        for n, a, p in events[:3] + events[-3:]:
            print(f"    {n}: allocated {a / gb:.3f} GB, peak so far "
                  f"{p / gb:.3f}", flush=True)
        del loss, grads, alias, events
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
