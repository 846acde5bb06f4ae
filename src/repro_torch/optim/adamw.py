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

ZeRO-1 (``zero1_pspecs``, ``repro/optim/adamw.py:98-117``) shards the
moments over a mesh's data axis: a moment takes its parameter's spec with
the data axes added on its first unsplit dimension that they divide.
``launch.train.jit_train_step`` updates each data slot's slice of a
parameter against its slice of the moments (``update_leaf``), then
all-gathers the parameter over the data slots.
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


def schedule(cfg: AdamWConfig, count: torch.Tensor):
    """(lr, bc1, bc2) at the int32 step count ``count`` (already advanced
    by one)."""
    count_f = count.float()
    return (cosine_lr(cfg, count_f), 1 - cfg.beta1 ** count_f,
            1 - cfg.beta2 ** count_f)


def clip_scale(cfg: AdamWConfig, gnorm: torch.Tensor) -> torch.Tensor:
    return torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                       max=1.0)


def update_leaf(cfg: AdamWConfig, g, m, v, p, *, lr, scale, bc1, bc2,
                inplace: bool):
    """One leaf's AdamW update, the JAX package's expression in its order
    of operations: ``(p, m, v)`` new, or with ``inplace`` written into
    the given tensors."""
    g = g.float() * scale
    m_new = cfg.beta1 * m + (1 - cfg.beta1) * g
    v_new = cfg.beta2 * v + (1 - cfg.beta2) * g * g
    step_ = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
    p32 = p.float()
    p_new = (p32 - lr * (step_ + cfg.weight_decay * p32)).to(p.dtype)
    if inplace:
        return p.copy_(p_new), m.copy_(m_new), v.copy_(v_new)
    return p_new, m_new, v_new


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
    lr, bc1, bc2 = schedule(cfg, count)
    gnorm = global_norm(grads)
    scale = clip_scale(cfg, gnorm)

    def upd(g, m, v, p):
        return update_leaf(cfg, g, m, v, p, lr=lr, scale=scale, bc1=bc1,
                           bc2=bc2, inplace=inplace)

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


# ---------------------------------------------------------------------------
# ZeRO-1 sharding of optimizer state
# ---------------------------------------------------------------------------

def _zero1_spec(spec: Tuple, shape: Tuple[int, ...],
                data_size: int, data_axes) -> Tuple:
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = list(spec)
    for i, (ax, dim) in enumerate(zip(spec, shape)):
        if ax is None and dim % data_size == 0 and dim >= data_size:
            out[i] = data_axes
            break
    return tuple(out)


def zero1_pspecs(param_pspecs: Tree, param_shapes: Tree,
                 data_size: int, data_axes="data") -> Tree:
    """Moment pspecs: param pspecs with the data axis added on the first
    divisible unsharded dim (falls back to the param spec when none
    fits).  ``param_shapes`` is a matching tree of tensors (``meta`` ones
    from ``init_params(cfg, device="meta")``, say)."""
    def one(spec, shaped):
        if isinstance(spec, tuple):
            return _zero1_spec(spec, tuple(shaped.shape), data_size,
                               data_axes)
        if isinstance(spec, dict):
            return {k: one(v, shaped[k]) for k, v in spec.items()}
        return [one(v, s) for v, s in zip(spec, shaped)]
    return one(param_pspecs, param_shapes)
