"""Shared model utilities: dtype policy, RoPE, activations, RMSNorm.

The counterparts of ``repro.models.common`` for one device.  The mesh
helpers (``constrain``, ``set_mesh_context``) and the remat tag (``tag``)
are not ported: the port has no device mesh and no training step yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


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


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6, *,
             fused: bool = False) -> torch.Tensor:
    """``x · rsqrt(mean x² + eps) · (1 + w)`` in fp32, in x's dtype.

    ``fused`` (the plan's ``use_fused_rmsnorm``) goes through the B7 kernel
    wrapper, which launches the kernel for tensors on the card and runs its
    plain version on the CPU; both compute this same function."""
    if fused:
        from ..kernels.rmsnorm import rmsnorm
        return rmsnorm(x, w, eps=eps)
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.to(torch.float32))
            ).to(x.dtype)
