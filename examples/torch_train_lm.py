"""End-to-end training driver on the port: train a granite-family LM on the
synthetic Markov corpus with the CELLO plan, AdamW, checkpointing and
straggler tracking.  Loss should drop from ~log(vocab) toward the source's
conditional entropy (~log(branching)).

The PyTorch/CUDA twin of ``examples/train_lm.py``: the same presets,
flags, defaults and printed lines.  The forward runs on the hand-written
kernels the plan turns on (B5 flash attention, B6 fused MLP, B7 RMSNorm,
each under its ``models.autograd`` Function), the backward through their
plain forms, and every ``checkpoint_every`` steps an
``AsyncCheckpointer`` snapshots the card's tensors to the host and writes
them off the training thread.

    PYTHONPATH=src python examples/torch_train_lm.py                 # ~0.1M params
    PYTHONPATH=src python examples/torch_train_lm.py --preset 100m   # ~100M params
    PYTHONPATH=src python examples/torch_train_lm.py --steps 3 --device cpu

``--device cuda`` (the default) raises without a card; ``--device cpu``
runs the kernels' plain torch versions.  ``main(argv)`` returns what it
printed as data.
"""
import argparse
import dataclasses
import math
import os
import tempfile

from repro_torch.api import Session
from repro_torch.checkpoint import AsyncCheckpointer, latest_step
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import StragglerDetector

PRESETS = {
    # name: (n_layers, d_model, n_heads, kv, d_ff, vocab, batch, seq)
    "tiny": (2, 64, 4, 2, 128, 512, 8, 64),
    "10m": (4, 256, 8, 4, 640, 4096, 8, 128),
    "100m": (8, 640, 10, 5, 1706, 16384, 8, 256),
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "cello_train_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; raises without a card) or cpu "
                         "(their plain torch versions)")
    args = ap.parse_args(argv)

    L, D, H, KV, F, V, B, S = PRESETS[args.preset]
    cfg = dataclasses.replace(
        get_config("granite-3-8b"), n_layers=L, d_model=D, n_heads=H,
        n_kv_heads=KV, head_dim=D // H, d_ff=F, vocab=V,
        name=f"granite-{args.preset}")
    print(f"model: {cfg.name}  params≈{cfg.total_params() / 1e6:.1f}M")

    compiled = Session(cfg, device=args.device).default_plan(seq=S)
    data = SyntheticLMData(DataConfig(vocab=V, seq_len=S, global_batch=B,
                                      seed=0))
    print(f"data: markov synthetic, loss floor ≈ {data.entropy_floor():.3f} "
          f"nats (uniform would be {math.log(V):.3f})")

    straggler = StragglerDetector()
    ck = AsyncCheckpointer(args.ckpt_dir, keep=2)
    out = compiled.train(
        data_iter=iter(data), n_steps=args.steps,
        opt_cfg=AdamWConfig(lr=args.lr, warmup_steps=20,
                            total_steps=args.steps, weight_decay=0.01),
        checkpointer=ck, checkpoint_every=max(50, args.steps // 4),
        straggler=straggler, log_every=10)

    hist = out["history"]
    print(f"\nloss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
          f"(floor ≈ {data.entropy_floor():.3f})")
    print(f"median step time: {straggler.median_step_s * 1e3:.0f} ms")
    print(f"checkpoints in {args.ckpt_dir}")
    return {"model": cfg.name, "params_m": cfg.total_params() / 1e6,
            "losses": [h["loss"] for h in hist],
            "entropy_floor": data.entropy_floor(),
            "median_step_s": straggler.median_step_s,
            "ckpt_dir": args.ckpt_dir,
            "latest_checkpoint": latest_step(args.ckpt_dir),
            "params": out["params"], "opt_state": out["opt_state"]}


if __name__ == "__main__":
    main()
