"""B9 · WKV6: the CUDA C++ kernel ``csrc/wkv6.cu`` and its plain version.

Replaces ``repro/kernels/rwkv6/kernel.py:26`` ``_wkv6_kernel`` / ``:47``
``wkv6`` (with ``ref.py``'s semantics): per (batch, head), with an E×E fp32
state S, ``y_t[j] = Σ_i r_i·(S_ij + u_i·k_i·v_j)`` and ``S_ij ←
exp(−exp(w_i))·S_ij + k_i·v_j``; y in r's type, the final state in fp32.
The kernel gives each (batch, head) one block whose threads keep one
column of S each in registers across the sequence (see the source for the
design and its bound).  ``models.recurrent.apply_rwkv_seq`` launches
it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import LAUNCHES, on_cuda

MAX_HEAD_DIM = 64
_DTYPES = (torch.bfloat16, torch.float32)


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               s0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX reference's arithmetic, a Python loop over t.  r, k, v, w:
    (B, H, S, E), w the log-decay pre-activation; u: (H, E); s0:
    (B, H, E, E) or None.  Returns (y (B, H, S, E) in r's dtype, sT fp32)."""
    B, H, S, E = r.shape
    rf, kf, vf = (t.float() for t in (r, k, v))
    decay = torch.exp(-torch.exp(w.float()))
    uf = u.float()[None, :, :, None]
    s = (torch.zeros((B, H, E, E), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    y = torch.empty((B, H, S, E), dtype=r.dtype, device=r.device)
    for t in range(S):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        y[:, :, t] = torch.einsum("bhi,bhij->bhj", rf[:, :, t], s + uf * kv)
        s = decay[:, :, t, :, None] * s + kv
    return y, s


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, s0: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV6 over r, k, v (B, H, S, E) of one dtype, the fp32 log decay w
    (B, H, S, E), the fp32 bonus u (H, E) and the optional fp32 initial
    state s0 (B, H, E, E).  Any strides over (B, H, S), unit stride over E;
    y takes r's strides.  Returns (y, sT)."""
    given = [t for t in (r, k, v, w, u, s0) if t is not None]
    if not on_cuda(*given):
        return wkv6_plain(r, k, v, w, u, s0)
    from .build import check, cuda_library
    B, H, S, E = r.shape
    if (r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype
            or w.dtype != torch.float32 or u.dtype != torch.float32
            or (s0 is not None and s0.dtype != torch.float32)):
        raise TypeError(f"wkv6 kernel takes bfloat16/float32 r, k, v of one "
                        f"dtype and float32 w, u, s0, got {r.dtype}, "
                        f"{k.dtype}, {v.dtype}, {w.dtype}, {u.dtype}, "
                        f"{None if s0 is None else s0.dtype}")
    if (any(t.shape != r.shape for t in (k, v, w)) or u.shape != (H, E)
            or (s0 is not None and s0.shape != (B, H, E, E))
            or not 0 < E <= MAX_HEAD_DIM):
        raise ValueError(f"wkv6: r {tuple(r.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, w {tuple(w.shape)}, u "
                         f"{tuple(u.shape)}, s0 "
                         f"{None if s0 is None else tuple(s0.shape)} (need "
                         f"E <= {MAX_HEAD_DIM})")
    if (any(t.stride(-1) != 1 for t in (r, k, v, w))
            or not u.is_contiguous()
            or (s0 is not None and not s0.is_contiguous())):
        raise ValueError("wkv6 kernel takes unit stride over E and "
                         "contiguous u and s0")
    y = torch.empty_like(r)
    s_out = torch.empty((B, H, E, E), dtype=torch.float32, device=r.device)
    strides = (ctypes.c_longlong * 15)(
        *[st for t in (r, k, v, w, y) for st in t.stride()[:3]])
    fn = (cuda_library().cello_wkv6_bf16 if r.dtype == torch.bfloat16
          else cuda_library().cello_wkv6_f32)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    LAUNCHES["wkv6"] += 1
    check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), None if s0 is None else s0.data_ptr(),
             y.data_ptr(), s_out.data_ptr(), ctypes.addressof(strides),
             B, H, S, E, stream), "wkv6")
    return y, s_out
