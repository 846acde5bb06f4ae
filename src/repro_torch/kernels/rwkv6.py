"""B9 · WKV6: the CUDA C++ kernel ``csrc/wkv6.cu`` and its plain version.

Replaces ``repro/kernels/rwkv6/kernel.py:26`` ``_wkv6_kernel`` / ``:47``
``wkv6`` (with ``ref.py``'s semantics): per (batch, head), with an E×E fp32
state S, ``y_t[j] = Σ_i r_i·(S_ij + u_i·k_i·v_j)`` and ``S_ij ←
exp(−exp(w_i))·S_ij + k_i·v_j``; y in r's type, the final state in fp32.
The kernel runs the recurrence's exact chunked form (``CHUNK`` steps a
chunk, only the chunk-to-chunk state pass serial), one block per (group
of 32 value columns, head, batch); :func:`wkv6_plain` repeats its
arithmetic (see the source for the design and its bound).
``models.recurrent.apply_rwkv_seq`` launches it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import count, on_cuda, report_work

MAX_HEAD_DIM = 64
#: time steps per chunk of the chunked form (``kChunk`` in ``csrc/wkv6.cu``)
CHUNK = 16
_DTYPES = (torch.bfloat16, torch.float32)


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               s0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B9's plain version: the kernel's chunked arithmetic, vectorised over
    chunks of ``CHUNK`` steps, with only the chunk-to-chunk state pass a
    loop.  r, k, v, w: (B, H, S, E), w the log-decay pre-activation; u:
    (H, E); s0: (B, H, E, E) or None.  Returns (y (B, H, S, E) in r's
    dtype, sT fp32).

    Per chunk, with d_t = exp(−exp(w_t)) and every decay a product of the
    d between the two steps (never a quotient or a difference of
    cumulative sums, which lose accuracy at strong decays):

    * G_t = Π_{τ<t} d_τ (the chunk-start state's decay at step t), its
      last product the decay over the chunk;
    * P_ts = Σ_i r_ti·k_si·Π_{s<τ<t} d_τi for s < t, and the bonus
      P_tt = Σ_i r_ti·u_i·k_ti;
    * y_t = (r_t ⊙ G_t)·S_0 + Σ_{s≤t} P_ts·v_s;
    * S_C = diag(Π_τ d_τ)·S_0 + Σ_s (k_s ⊙ Π_{τ>s} d_τ)·v_sᵀ.

    A ragged last chunk is padded with zero r, k, v and a decay of 1."""
    B, H, S, E = r.shape
    C = CHUNK
    N = -(-S // C)
    pad = N * C - S

    def chunks(t: torch.Tensor, value: float = 0.0) -> torch.Tensor:
        return F.pad(t.float(), (0, 0, 0, pad), value=value).reshape(
            B, H, N, C, E)

    rf, kf, vf = chunks(r), chunks(k), chunks(v)
    d = chunks(torch.exp(-torch.exp(w.float())), 1.0)
    incl = torch.cumprod(d, dim=3)
    decay_in = torch.cat([torch.ones_like(d[:, :, :, :1]),
                          incl[:, :, :, :-1]], 3)            # G_t
    decay_out = torch.cat([torch.cumprod(d[:, :, :, 1:].flip(3), 3).flip(3),
                           torch.ones_like(d[:, :, :, :1])], 3)  # Π_{τ>s}
    # [t, s] = k_s ⊙ Π_{s<τ<t} d_τ, multiplied in from k_s on, as the
    # kernel walks t upward
    kpair = torch.zeros((B, H, N, C, C, E), dtype=torch.float32,
                        device=r.device)
    for s in range(C - 1):
        kpair[:, :, :, s + 1:, s] = torch.cumprod(
            torch.cat([kf[:, :, :, s:s + 1], d[:, :, :, s + 1:C - 1]], 3), 3)
    scores = torch.einsum("bhnti,bhntsi->bhnts", rf, kpair)
    bonus = (rf * u.float()[None, :, None, None, :] * kf).sum(-1)
    scores = scores + torch.diag_embed(bonus)
    y = torch.einsum("bhnts,bhnsj->bhntj", scores, vf)
    rd, kd = rf * decay_in, kf * decay_out
    state = (torch.zeros((B, H, E, E), dtype=torch.float32, device=r.device)
             if s0 is None else s0.float())
    starts = []
    for n in range(N):
        starts.append(state)
        state = (incl[:, :, n, -1, :, None] * state
                 + torch.einsum("bhsi,bhsj->bhij", kd[:, :, n], vf[:, :, n]))
    if N:
        y = y + torch.einsum("bhnti,bhnij->bhntj", rd,
                             torch.stack(starts, 2))
    return y.reshape(B, H, N * C, E)[:, :, :S].to(r.dtype), state


def work(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, s0: Optional[torch.Tensor] = None
         ) -> Tuple[int, int]:
    """(operations, least bytes) of one call, the fewest operations: per
    state element and step, 2 for y's Σ_i r_i·S_ij and 3 for S_ij ←
    d_i·S_ij + k_i·v_j; per lane and step, 3 for Σ_i r_i·u_i·k_i, 2 for
    y_j += v_j·(that) and 2 for the decay exp(−exp(w_i)).  r, k, v and w
    read and y written once, u read, sT written and s0 read once."""
    B, H, S, E = r.shape
    n = B * H * S * E
    return (5 * n * E + 7 * n,
            4 * r.element_size() * n + 4 * n + 4 * H * E
            + 4 * B * H * E * E * (1 if s0 is None else 2))


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, s0: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV6 over r, k, v (B, H, S, E) of one dtype, the fp32 log decay w
    (B, H, S, E), the fp32 bonus u (H, E) and the optional fp32 initial
    state s0 (B, H, E, E).  Any strides over (B, H, S), unit stride over E;
    y takes r's strides.  Returns (y, sT); on meta tensors empty ones, and
    nothing launched."""
    given = [t for t in (r, k, v, w, u, s0) if t is not None]
    if not on_cuda(*given, meta=True):
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
    report_work("wkv6", *work(r, k, v, w, u, s0))
    if y.is_meta:
        return y, s_out
    strides = (ctypes.c_longlong * 15)(
        *[st for t in (r, k, v, w, y) for st in t.stride()[:3]])
    fn = (cuda_library().cello_wkv6_bf16 if r.dtype == torch.bfloat16
          else cuda_library().cello_wkv6_f32)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    count("wkv6")
    check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), None if s0 is None else s0.data_ptr(),
             y.data_ptr(), s_out.data_ptr(), ctypes.addressof(strides),
             B, H, S, E, stream), "wkv6")
    return y, s_out
