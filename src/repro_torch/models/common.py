"""Shared model utilities: dtype policy, RoPE, activations, RMSNorm, and
the remat tags.

The counterparts of ``repro.models.common`` for one device.  The mesh
helpers (``constrain``, ``set_mesh_context``) are not ported: the port has
no LLM device mesh yet.

``tag`` is the counterpart of ``checkpoint_name``: an identity op
(``repro_torch::tag``, registered with ``torch.library``) that carries a
name, so that a :class:`RematPolicy` (``CelloPlan.checkpoint_policy()``)
can keep exactly the named tensors through selective activation
checkpointing and recompute the rest.
"""
from __future__ import annotations

from typing import Iterable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


def dense_init(gen: torch.Generator, shape, scale: float, device,
               dtype=PARAM_DTYPE) -> torch.Tensor:
    """``scale`` times standard normal draws from ``gen``, in ``dtype``."""
    out = torch.randn(shape, generator=gen, device=device,
                      dtype=torch.float32)
    return out.mul_(scale).to(dtype)


def bf16(w: torch.Tensor) -> torch.Tensor:
    """A weight in the compute dtype, as the JAX package casts it."""
    return w.to(COMPUTE_DTYPE)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., S, H, E) or (..., S, E); positions: (..., S)."""
    E = x.shape[-1]
    freqs = rope_freqs(E, theta, x.device)                       # (E/2,)
    ang = positions[..., None].to(torch.float32) * freqs         # (..., S, E/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    extra = x.dim() - ang.dim() - 1
    for _ in range(extra):
        cos, sin = cos[..., None, :], sin[..., None, :]
    xf1 = x[..., :E // 2].to(torch.float32)
    xf2 = x[..., E // 2:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def activation_fn(kind: str):
    if kind in ("swiglu", "silu"):
        return F.silu
    if kind in ("geglu", "gelu"):
        return lambda x: F.gelu(x, approximate="tanh")
    if kind == "relu2":
        return lambda x: torch.square(torch.relu(x))
    raise ValueError(kind)


def is_gated(kind: str) -> bool:
    return kind in ("swiglu", "geglu")


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``x · rsqrt(mean x² + eps) · (1 + w)`` in fp32, in x's dtype (B7,
    ``models.autograd.RMSNormFn``, computes the same function)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.to(torch.float32))
            ).to(x.dtype)


# ---------------------------------------------------------------------------
# remat: tags and the selective-checkpoint policy
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::tag", mutates_args=())
def _tag_op(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()             # a custom op's output may not alias x


_tag_op.register_autograd(lambda ctx, grad: (grad, None))


def tag(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` under the remat name ``name``.  Only a backward reads a name,
    so where none will run (grad mode off, or ``x`` needs no gradient) the
    tensor is returned as it is and no op is dispatched."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _tag_op(x, name)
    return x


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class RematPolicy:
    """Selective activation checkpointing that keeps the tensors tagged
    with one of ``save_names`` and recomputes everything else (``()``: the
    JAX package's ``nothing_saveable``; otherwise its
    ``save_only_these_names``).

    :meth:`checkpoint` runs one region (a layer) under
    ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` with
    this object as the policy of ``create_selective_checkpoint_contexts``.
    The backward re-runs the whole region, the kept tags' outputs taken
    from the cache, so an ``autograd.Function`` inside it (a kernel
    launch no aten op shows) runs its forward again.  ``saved_bytes``
    counts what the policy keeps: the regions' inputs that are not
    parameters, and every kept tag's output."""

    def __init__(self, save_names: Iterable[str] = ()):
        self.save_names = frozenset(save_names)
        self.saved_bytes = 0

    def __repr__(self) -> str:
        return f"RematPolicy({sorted(self.save_names)})"

    def __call__(self, ctx, op, *args, **kwargs):
        if (op is torch.ops.repro_torch.tag.default
                and args[1] in self.save_names):
            if not ctx.is_recompute:
                self.saved_bytes += _nbytes(args[0])
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    def _contexts(self):
        return create_selective_checkpoint_contexts(self)

    def checkpoint(self, fn, *args):
        """``fn(*args)`` as one checkpointed region."""
        self.saved_bytes += sum(_nbytes(a) for a in args
                                if not (isinstance(a, torch.Tensor)
                                        and a.is_leaf))
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=self._contexts)
