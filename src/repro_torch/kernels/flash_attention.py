"""B5 · flash attention: the CUDA C++ kernel ``csrc/flash_attention.cu`` and
its plain version.

Replaces ``repro/kernels/flash_attention/kernel.py:30`` ``_flash_kernel`` /
``:90`` ``flash_attention`` (with ``ops.py``'s lane padding and ``ref.py``'s
semantics): online-softmax attention, causal and/or a sliding window, GQA
(query head h reads kv head h·KVH/H), queries aligned to the end of the keys
(``q_offset = T - S``), fp32 softmax and accumulators on bf16 or fp32
operands.  Layout as in the TPU kernel: q ``(B, H, S, E)``, k and v ``(B,
KVH, T, E)``; any strides over the first three axes, unit stride over E.  E
may be up to 256.

bf16 operands run on the tensor cores: the scores are the exact products
of the bf16 values summed in fp32, then scaled; P·V takes P split into two
bf16 halves, ``P_hi = bf16(P)`` and ``P_lo = bf16(P - P_hi)``.  fp32
operands run on the CUDA cores with q scaled before the product.  The plain
version repeats whichever arithmetic the kernel runs.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import LAUNCHES, on_cuda

#: keys per kv tile of the plain version and of the fp32 kernel (the bf16
#: kernel takes 64, or 32 where E > 128)
TILE = 64
NEG_INF = -1e30
MAX_HEAD_DIM = 256
_DTYPES = (torch.bfloat16, torch.float32)


def split_bf16(p: torch.Tensor):
    """``(P_hi, P_lo)``: fp32 ``p`` rounded to bf16, and the remainder
    rounded to bf16, both as fp32 (the kernel's A fragments of P·V)."""
    hi = p.to(torch.bfloat16).float()
    return hi, (p - hi).to(torch.bfloat16).float()


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's arithmetic in torch: an online softmax over 64-key
    tiles with the TPU kernel's -1e30 mask, fp32 m, l and accumulator,
    ``acc / max(l, 1e-30)``.  fp32 operands: q scaled in fp32 before the
    product.  bf16 operands: the scale after the product, and P·V as
    ``P_lo·V + P_hi·V`` (``split_bf16``).  It runs every kv tile
    (the kernel skips fully masked ones, which changes nothing: a masked
    tile adds p = 0 to a row that has seen a key, and a row that has not is
    reset by the first key it sees)."""
    B, H, S, E = q.shape
    KVH, T = k.shape[1], k.shape[2]
    if H % KVH:
        raise ValueError(f"{H} query heads do not group over {KVH} kv heads")
    G = H // KVH
    scale = E ** -0.5 if scale is None else scale
    tensor_cores = q.dtype == torch.bfloat16
    qf = q.float().reshape(B, KVH, G, S, E)
    if not tensor_cores:
        qf = qf * scale
    q_pos = torch.arange(S, device=q.device)[:, None] + (T - S)
    m = torch.full((B, KVH, G, S, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KVH, G, S, E), device=q.device)
    for k0 in range(0, T, TILE):
        kt = k[:, :, k0:k0 + TILE].float()
        vt = v[:, :, k0:k0 + TILE].float()
        s = torch.einsum("bkgse,bkte->bkgst", qf, kt)
        if tensor_cores:
            s = s * scale
        k_pos = torch.arange(k0, k0 + kt.shape[2], device=q.device)[None, :]
        mask = torch.ones((S, kt.shape[2]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= k_pos <= q_pos
        if window is not None:
            mask &= k_pos > q_pos - window
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        if tensor_cores:
            p_hi, p_lo = split_bf16(p)
            pv = (torch.einsum("bkgst,bkte->bkgse", p_lo, vt)
                  + torch.einsum("bkgst,bkte->bkgse", p_hi, vt))
        else:
            pv = torch.einsum("bkgst,bkte->bkgse", p, vt)
        acc = acc * alpha + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(B, H, S, E).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention.  q ``(B, H, S, E)``; k, v ``(B, KVH, T, E)``.
    Returns ``(B, H, S, E)`` in q's dtype, with q's strides."""
    if not on_cuda(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    from .build import check, cuda_library
    B, H, S, E = q.shape
    KVH, T = k.shape[1], k.shape[2]
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention kernel takes bfloat16/float32 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if (k.shape != (B, KVH, T, E) or v.shape != k.shape or H % KVH
            or not 0 < E <= MAX_HEAD_DIM):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} (need GQA "
                         f"heads and E <= {MAX_HEAD_DIM})")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention kernel takes unit stride over E")
    out = torch.empty_like(q)
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])
            for t in (q, k, v, out)):
        raise ValueError("flash_attention bf16 kernel copies 16-byte rows: "
                         "it takes 16-byte aligned pointers and strides over "
                         "(B, H, S) that are multiples of 8 elements")
    strides = (ctypes.c_longlong * 12)(
        *[st for t in (q, k, v, out) for st in t.stride()[:3]])
    fn = (cuda_library().cello_flash_attention_bf16
          if q.dtype == torch.bfloat16
          else cuda_library().cello_flash_attention_f32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale = E ** -0.5 if scale is None else scale
    LAUNCHES["flash_attention"] += 1
    check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             ctypes.addressof(strides), B, H, KVH, S, T, E, float(scale),
             int(causal), int(window or 0), stream), "flash_attention")
    return out
