"""Batched serving on the port: greedy decoding against a ring-buffered KV
cache with throughput stats, driven through the Session API.

The PyTorch/CUDA twin of ``examples/serve_batch.py``: the same flags,
defaults and printed lines.  The reduced config of ``--arch``, random
weights from seed 0 and a prompt drawn by a ``torch.Generator`` seeded 1;
``generate`` decodes through the bundle's graphed decode step (one
CUDA-graph replay a step), whose layers run the hand-written kernels the
plan turns on (B6 fused MLP and B7 RMSNorm in every dense layer; B8 / B9
where a recurrent arch is chosen).

    PYTHONPATH=src python examples/torch_serve_batch.py --arch h2o-danube-1.8b
    PYTHONPATH=src python examples/torch_serve_batch.py --device cpu

``--device cuda`` (the default) raises without a card; ``--device cpu``
runs the kernels' plain torch versions.  ``main(argv)`` returns what it
printed as data.
"""
import argparse
import time

import torch

from repro_torch.api import Session
from repro_torch.configs import get_config, list_archs
from repro_torch.launch.serve import ServeStats
from repro_torch.models import init_params


def make_prompt(batch: int, prompt_len: int, vocab: int, device
                ) -> torch.Tensor:
    """``(batch, prompt_len)`` tokens in ``[0, vocab)`` from a CPU
    generator seeded 1, so the prompt is the same on every device."""
    gen = torch.Generator().manual_seed(1)
    return torch.randint(0, vocab, (batch, prompt_len),
                         generator=gen).to(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; raises without a card) or cpu "
                         "(their plain torch versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()        # reduced-scale weights
    if cfg.encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only: no decode step")
    compiled = Session(cfg, device=args.device).default_plan(
        seq=args.prompt_len + args.new_tokens)
    bundle = compiled.serve()
    params = init_params(cfg, seed=0, device=compiled.device)
    prompt = make_prompt(args.batch, args.prompt_len, cfg.vocab,
                         compiled.device)

    t0 = time.perf_counter()
    out = bundle.generate(params, prompt, n_new=args.new_tokens).cpu()
    wall = time.perf_counter() - t0
    stats = ServeStats(tokens_generated=args.batch * args.new_tokens,
                       steps=args.prompt_len + args.new_tokens, wall_s=wall)
    print(f"arch          : {cfg.name}")
    print(f"generated     : {tuple(out.shape)} "
          f"({stats.tokens_generated} new tokens)")
    print(f"throughput    : {stats.tok_per_s:,.1f} tok/s "
          f"({compiled.device}, reduced config)")
    print(f"sample row    : {out[0].tolist()}")
    return {"arch": cfg.name, "tokens": out.numpy(),
            "tokens_generated": stats.tokens_generated,
            "tok_per_s": stats.tok_per_s, "wall_s": wall}


if __name__ == "__main__":
    main()
