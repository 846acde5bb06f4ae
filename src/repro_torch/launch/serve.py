"""Serving: prefill + decode steps and a batched greedy generation driver.

The counterpart of ``repro.launch.serve`` on one device (the mesh-bound
``jit_decode_step`` is not ported).  PyTorch runs eagerly, so the entry
points are plain functions; every tensor stays on the device of the
parameters and the prompt.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..core.policy import CelloPlan
from ..models import decode_step, forward, init_cache


def make_prefill_fn(cfg: ArchConfig, plan: CelloPlan):
    def prefill(params, tokens):
        logits, _ = forward(params, cfg, plan, tokens, mode="prefill")
        return logits
    return prefill


def make_decode_fn(cfg: ArchConfig, plan: CelloPlan):
    def serve_step(params, cache, tokens, pos):
        return decode_step(params, cache, cfg, plan, tokens, pos)
    return serve_step


def greedy_generate(params, cfg: ArchConfig, plan: CelloPlan,
                    prompt: torch.Tensor, n_new: int,
                    cache_len: Optional[int] = None) -> torch.Tensor:
    """Batched greedy decoding.

    prompt: (B, P) int.  Returns (B, P + n_new).  The prompt is fed token
    by token through the decode step, as the JAX driver does.
    """
    B, Plen = prompt.shape
    Z = cache_len or (Plen + n_new)
    cache = init_cache(cfg, B, Z, device=prompt.device)
    step = make_decode_fn(cfg, plan)
    toks = prompt
    logits = None
    for t in range(Plen):
        logits, cache = step(params, cache, toks[:, t:t + 1], t)
    for t in range(n_new):
        nxt = torch.argmax(logits[:, -1], dim=-1).to(prompt.dtype)[:, None]
        toks = torch.cat([toks, nxt], dim=1)
        if t < n_new - 1:
            logits, cache = step(params, cache, nxt, Plen + t)
    return toks


@dataclasses.dataclass(frozen=True)
class ServeBundle:
    """Serving entry points bound to one (cfg, plan) pair, produced by
    ``repro_torch.api.CompiledPlan.serve()``."""
    cfg: ArchConfig
    plan: CelloPlan

    @functools.cached_property
    def prefill_fn(self):
        return make_prefill_fn(self.cfg, self.plan)

    @functools.cached_property
    def decode_fn(self):
        return make_decode_fn(self.cfg, self.plan)

    def generate(self, params, prompt: torch.Tensor, n_new: int,
                 cache_len: Optional[int] = None) -> torch.Tensor:
        return greedy_generate(params, self.cfg, self.plan, prompt, n_new,
                               cache_len=cache_len)


def make_serving(cfg: ArchConfig, plan: CelloPlan) -> ServeBundle:
    return ServeBundle(cfg=cfg, plan=plan)


@dataclasses.dataclass
class ServeStats:
    tokens_generated: int
    steps: int
    wall_s: float

    @property
    def tok_per_s(self) -> float:
        return self.tokens_generated / max(self.wall_s, 1e-9)
