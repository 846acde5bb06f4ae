"""AdamW on the port's parameter tree (dicts and lists of tensors).

The counterpart of ``repro.optim.adamw``: fp32 moments, decoupled weight
decay, global-norm clipping, cosine schedule with linear warmup, the
learning rate and the bias corrections computed in fp32 from an int32
step count, each leaf's update the JAX package's expression in its order
of operations.

The update runs under ``torch.no_grad()``.  With ``inplace=True`` (the
port's form of the JAX train step's ``donate_argnums``) every new value is
written into the tensor it replaces, so parameters and moments keep their
storage; otherwise new tensors are returned and the inputs stay as they
were.  Both forms compute the same numbers.

ZeRO-1 (``zero1_pspecs``) shards the moments over a mesh's data axis and
comes with the LLM mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.utils._pytree as pytree

Tree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at fp32 ``step``: linear warmup, then a cosine to
    ``min_lr_frac`` of ``lr``."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def adamw_init(params: Tree) -> Dict[str, Any]:
    """Zero fp32 moments shaped like ``params`` and an int32 step count, on
    the parameters' device."""
    leaves = pytree.tree_leaves(params)
    device = leaves[0].device if leaves else None

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": pytree.tree_map(zeros, params),
            "v": pytree.tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    sums = [torch.sum(torch.square(x.float()))
            for x in pytree.tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Tree, state: Dict[str, Any],
                 params: Tree, *, inplace: bool = False
                 ) -> Tuple[Tree, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns ``(params, state, {"lr", "grad_norm"})``;
    with ``inplace`` the returned trees are the given ones, updated."""
    count = state["count"] + 1
    count_f = count.float()
    lr = cosine_lr(cfg, count_f)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    bc1 = 1 - cfg.beta1 ** count_f
    bc2 = 1 - cfg.beta2 ** count_f

    def upd(g, m, v, p):
        g = g.float() * scale
        m_new = cfg.beta1 * m + (1 - cfg.beta1) * g
        v_new = cfg.beta2 * v + (1 - cfg.beta2) * g * g
        step_ = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        p32 = p.float()
        p_new = (p32 - lr * (step_ + cfg.weight_decay * p32)).to(p.dtype)
        if inplace:
            return p.copy_(p_new), m.copy_(m_new), v.copy_(v_new)
        return p_new, m_new, v_new

    flat_g, spec = pytree.tree_flatten(grads)
    triples = [upd(g, m, v, p) for g, m, v, p in zip(
        flat_g, pytree.tree_leaves(state["m"]),
        pytree.tree_leaves(state["v"]), pytree.tree_leaves(params))]
    if inplace:
        state["count"].copy_(count)
        return params, state, {"lr": lr, "grad_norm": gnorm}
    new_p, new_m, new_v = (pytree.tree_unflatten([t[i] for t in triples],
                                                 spec) for i in range(3))
    return new_p, {"m": new_m, "v": new_v, "count": count}, {
        "lr": lr, "grad_norm": gnorm}
