"""Attention for the model zoo: chunked-flash, the B5 kernel, naive, decode.

The counterparts of ``repro.models.attention``; layouts as there: q
``(B, S, H, E)``, k and v ``(B, T, KVH, E)``, caches ``(B, Z, KVH, E)``.

* ``chunked_flash_attention`` — plain-torch online-softmax attention
  blocked along KV, with the JAX version's rounding (q scaled in its own
  dtype, probabilities cast to v's dtype before the PV product);
* ``flash_attention_bshe`` — the counterpart of ``pallas_attention``: the
  (B, S, H, E) adapter over the B5 kernel wrapper (the kernel on the card,
  its plain version on the CPU);
* ``naive_attention`` — materialises the (B, H, S, T) scores;
* ``decode_attention`` — one query token against a cache.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _f32_einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with fp32 accumulation (JAX's preferred_element_type=f32):
    the operands' products are exact in fp32, so casting them first
    computes the same sum."""
    return torch.einsum(spec, a.float(), b.float())


def naive_attention(q, k, v, *, causal: bool, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B,S,H,E); k,v: (B,T,KVH,E) -> (B,S,H,E). Materialises scores."""
    B, S, H, E = q.shape
    T, KVH = k.shape[1], k.shape[2]
    rep = H // KVH
    scale = E ** -0.5
    kr = k.repeat_interleave(rep, dim=2) if rep > 1 else k
    vr = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    s = torch.einsum("bshe,bthe->bhst", q.float(), kr.float()) * scale
    qi = torch.arange(S, device=q.device)[:, None] + q_offset
    kj = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhst,bthe->bshe", p, vr.float())
    return out.to(q.dtype)


def chunked_flash_attention(q, k, v, *, causal: bool,
                            window: Optional[int] = None,
                            kv_block: int = 512,
                            q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention blocked along KV.

    q: (B,S,H,E); k,v: (B,T,KVH,E) -> (B,S,H,E).  Peak intermediate is the
    (B,H,S,kv_block) score tile.
    """
    B, S, H, E = q.shape
    T, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = E ** -0.5
    kv_block = min(kv_block, T)
    qf = (q * torch.tensor(scale, dtype=q.dtype)).reshape(B, S, KVH, G, E)
    qf = qf.permute(0, 2, 3, 1, 4)                         # (B,KVH,G,S,E)
    kh = k.permute(0, 2, 1, 3)                             # (B,KVH,T,E)
    vh = v.permute(0, 2, 1, 3)
    qi = torch.arange(S, device=q.device)[:, None] + q_offset
    m = torch.full((B, KVH, G, S, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KVH, G, S, E), device=q.device)
    for j0 in range(0, T, kv_block):
        kblk = kh[:, :, j0:j0 + kv_block]
        vblk = vh[:, :, j0:j0 + kv_block]
        s = _f32_einsum("bkgse,bkte->bkgst", qf, kblk)
        kj = torch.arange(j0, j0 + kblk.shape[2], device=q.device)[None, :]
        mask = torch.ones((S, kblk.shape[2]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kj <= qi
        if window is not None:
            mask &= kj > qi - window
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + _f32_einsum("bkgst,bkte->bkgse",
                                        p.to(vblk.dtype), vblk)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)                  # (B,KVH,G,S,E)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H, E)
    return out.to(q.dtype)


def flash_attention_bshe(q, k, v, *, causal: bool,
                         window: Optional[int] = None) -> torch.Tensor:
    """(B,S,H,E)/(B,T,KVH,E) adapter over the B5 kernel's (B,H,S,E) layout:
    the kernel takes strided views, so nothing is transposed in memory."""
    from ..kernels.flash_attention import flash_attention
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, window=window)
    return out.transpose(1, 2)


def decode_attention(q, k_cache, v_cache, pos, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """One-token attention against a cache.

    q: (B,1,H,E); caches: (B,Z,KVH,E); pos: current position (the caches
    hold valid entries at [0, pos]).
    """
    B, _, H, E = q.shape
    Z, KVH = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    scale = E ** -0.5
    qg = (q * torch.tensor(scale, dtype=q.dtype)).reshape(B, KVH, G, E)
    s = _f32_einsum("bkge,btke->bkgt", qg, k_cache)           # (B,KVH,G,Z)
    kj = torch.arange(Z, device=q.device)[None, None, None, :]
    valid = kj <= pos
    if window is not None:
        valid &= kj > pos - window
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = _f32_einsum("bkgt,btke->bkge", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, E).to(q.dtype)
