"""Quickstart on the port: run the CELLO schedule × hybrid-buffer co-design
through the staged Session API and lower the result to an execution plan.

The PyTorch/CUDA twin of ``examples/quickstart.py``: the same flags,
defaults and printed lines, and the same plan field for field (the port's
planning layer is a copy of the JAX package's).  It plans only: no kernel
runs.  The session is bound to ``--device`` all the same (``cuda`` by
default, which raises without a card), as every entry point of the port.

    PYTHONPATH=src python examples/torch_quickstart.py [--arch granite-3-8b] [--phase train]
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

``main(argv)`` returns what it printed as data.
"""
import argparse
import dataclasses

from repro_torch.api import CodesignConfig, Session
from repro_torch.configs import list_archs
from repro_torch.core.buffer import MiB


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b", choices=list_archs())
    ap.add_argument("--phase", default="train",
                    choices=("train", "prefill", "decode"))
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=8192,
                    help="sequence length (train/prefill) or KV length "
                         "(decode)")
    ap.add_argument("--capacity-mib", type=int, default=128)
    ap.add_argument("--strategy", default="default",
                    choices=("default", "exhaustive", "greedy", "alap"))
    ap.add_argument("--no-cache", action="store_true",
                    help="force a fresh search (skip the disk cache)")
    ap.add_argument("--device", default="cuda",
                    help="the session's device: cuda (raises without a "
                         "card) or cpu")
    args = ap.parse_args(argv)

    sess = Session(args.arch, device=args.device,
                   capacity_bytes=args.capacity_mib * MiB,
                   use_cache=not args.no_cache)
    shape = (dict(batch=args.batch, kv_len=args.seq)
             if args.phase == "decode"
             else dict(batch=args.batch, seq=args.seq))

    # stage 1+2: trace the op DAG, analyse its reuse structure
    traced = sess.trace(phase=args.phase, **shape)
    analyzed = traced.analyze()
    print(traced)
    print(analyzed)
    top = analyzed.pin_candidates()[:3]
    if top:
        print("top pin candidates   :",
              ", ".join(f"{t.name} (saves {t.pin_value():.1f} B/B)"
                        for t in top))

    # stage 3: the joint schedule × buffer-split search
    designed = analyzed.codesign(CodesignConfig(strategy=args.strategy))
    print(f"\n{designed}")
    best = designed.best.metrics
    baselines = {}
    for name, ev in designed.baselines.items():
        baselines[name] = dict(
            speedup=ev.metrics.time_s / best.time_s,
            energy=ev.metrics.energy_j / best.energy_j,
            hbm=ev.metrics.hbm_bytes / max(1, best.hbm_bytes))
        print(f"  vs {name:13s}: speedup "
              f"{baselines[name]['speedup']:5.2f}x   energy "
              f"{baselines[name]['energy']:5.2f}x   HBM "
              f"{baselines[name]['hbm']:6.1f}x")

    # stage 4: lower onto kernels + remat policy
    plan = designed.lower()
    print("\n" + plan.explain())
    return {"traced": str(traced), "analyzed": str(analyzed),
            "pin_candidates": [(t.name, t.pin_value()) for t in top],
            "codesign": str(designed), "baselines": baselines,
            "plan": dataclasses.asdict(plan.plan),
            "explain": plan.explain()}


if __name__ == "__main__":
    main()
