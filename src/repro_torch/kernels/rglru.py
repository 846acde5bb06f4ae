"""B8 · RG-LRU scan: the CUDA C++ kernel ``csrc/rglru.cu`` and its plain
version.

Replaces ``repro/kernels/rglru/kernel.py:27`` ``_rglru_kernel`` / ``:48``
``rglru`` (with ``ref.py``'s semantics): per channel,
``a = exp(−8·softplus(Λ)·σ(g_r))`` and ``h = a·h + sqrt(max(1 − a², 1e-12))
·(σ(g_i)·x)`` over time, in fp32; y in x's type, the final state in fp32.
The kernel runs the scan in chunks of ``CHUNK`` steps: one launch scans
every chunk but the last from a zero state and keeps its product of decays
and its end state, a second folds those pairs into each chunk's incoming
state in chunk order and scans the chunk again from it (one launch when S
≤ ``CHUNK``).  :func:`rglru_plain` repeats that arithmetic (see the source
for the design and its bound).  ``models.recurrent.apply_rglru_seq``
launches it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import count, on_cuda

#: the RG-LRU's fixed scale of the log decay (``RGLRU_C``)
RGLRU_C = 8.0
#: time steps per chunk of the chunked scan (``kChunkLen`` in
#: ``csrc/rglru.cu``)
CHUNK = 64
_DTYPES = (torch.bfloat16, torch.float32)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``'s form, ``log1p(exp(−|x|)) + max(x, 0)`` (torch's
    ``F.softplus`` switches to x above a threshold and rounds otherwise)."""
    return torch.log1p(torch.exp(-x.abs())) + torch.clamp_min(x, 0.0)


def decay_and_input(x: torch.Tensor, gate_r: torch.Tensor,
                    gate_i: torch.Tensor, a_param: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every step's decay a and input b = sqrt(max(1 − a², 1e-12))·σ(g_i)·x,
    fp32 (B, S, D): the scan is then h = a·h + b."""
    r = torch.sigmoid(gate_r.float())
    i = torch.sigmoid(gate_i.float())
    a = torch.exp(-RGLRU_C * softplus(a_param.float()) * r)
    return a, torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * x.float())


def rglru_plain(x: torch.Tensor, gate_r: torch.Tensor, gate_i: torch.Tensor,
                a_param: torch.Tensor, h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B8's plain version: the kernel's chunked scan, vectorised over chunks
    of ``CHUNK`` steps.  x, gate_r, gate_i: (B, S, D); a_param: (D,); h0:
    (B, D) or None.  Returns (y (B, S, D) in x's dtype, hT (B, D) fp32).

    With a_t and b_t for all t (:func:`decay_and_input`), each chunk is
    scanned from h = 0 (its end state h_loc) while its decay P = 1 − Q
    builds up as Q = Q·a + (1 − a) from Q = 0, one step at a time; the
    chunks' incoming states are then folded in chunk order, h = P·h +
    h_loc, from h0 (or 0); last, each chunk is scanned again from its
    incoming state.  Each product and sum is its own torch op, as the
    kernel rounds each on its own.  A ragged last chunk is padded with a =
    1 and b = 0, steps that leave h and Q unchanged exactly."""
    B, S, D = x.shape
    C = CHUNK
    N = max(1, -(-S // C))
    a, b = decay_and_input(x, gate_r, gate_i, a_param)
    pad = (0, 0, 0, N * C - S)
    a = F.pad(a, pad, value=1.0).reshape(B, N, C, D)
    b = F.pad(b, pad).reshape(B, N, C, D)
    h = torch.zeros((B, N - 1, D), dtype=torch.float32, device=x.device)
    q = torch.zeros_like(h)
    for t in range(C):                       # every chunk but the last
        h = a[:, :-1, t] * h + b[:, :-1, t]
        q = q * a[:, :-1, t] + (1.0 - a[:, :-1, t])
    decay = 1.0 - q
    h_in = [torch.zeros((B, D), dtype=torch.float32, device=x.device)
            if h0 is None else h0.float()]
    for n in range(N - 1):                   # the fold, in chunk order
        h_in.append(decay[:, n] * h_in[-1] + h[:, n])
    h = torch.stack(h_in, 1)
    y = torch.empty((B, N, C, D), dtype=x.dtype, device=x.device)
    for t in range(C):                       # every chunk from its state
        h = a[:, :, t] * h + b[:, :, t]
        y[:, :, t] = h
    return y.reshape(B, N * C, D)[:, :S].contiguous(), h[:, -1]


def rglru(x: torch.Tensor, gate_r: torch.Tensor, gate_i: torch.Tensor,
          a_param: torch.Tensor, h0: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU scan of ``x`` (B, S, D) under the gates' pre-activations
    (x's dtype and shape), the fp32 ``a_param`` (D,) and the optional fp32
    initial state ``h0`` (B, D).  Returns (y, hT).  On CUDA one call is
    two kernel launches (one when S ≤ ``CHUNK``) and counts once."""
    given = [t for t in (x, gate_r, gate_i, a_param, h0) if t is not None]
    if not on_cuda(*given):
        return rglru_plain(x, gate_r, gate_i, a_param, h0)
    from .build import check, cuda_library
    B, S, D = x.shape
    if (x.dtype not in _DTYPES or gate_r.dtype != x.dtype
            or gate_i.dtype != x.dtype or a_param.dtype != torch.float32
            or (h0 is not None and h0.dtype != torch.float32)):
        raise TypeError(f"rglru kernel takes bfloat16/float32 x and gates of "
                        f"one dtype and float32 a_param and h0, got "
                        f"{x.dtype}, {gate_r.dtype}, {gate_i.dtype}, "
                        f"{a_param.dtype}, {None if h0 is None else h0.dtype}")
    if (gate_r.shape != x.shape or gate_i.shape != x.shape
            or a_param.shape != (D,)
            or (h0 is not None and h0.shape != (B, D))):
        raise ValueError(f"rglru: x {tuple(x.shape)}, gates "
                         f"{tuple(gate_r.shape)}, {tuple(gate_i.shape)}, "
                         f"a_param {tuple(a_param.shape)}, h0 "
                         f"{None if h0 is None else tuple(h0.shape)}")
    if not all(t.is_contiguous() for t in given):
        raise ValueError("rglru kernel takes contiguous tensors")
    y = torch.empty_like(x)
    h_out = torch.empty((B, D), dtype=torch.float32, device=x.device)
    carry = torch.empty((B, max(0, -(-S // CHUNK) - 1), D, 2),
                        dtype=torch.float32, device=x.device)
    fn = (cuda_library().cello_rglru_bf16 if x.dtype == torch.bfloat16
          else cuda_library().cello_rglru_f32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    count("rglru")
    check(fn(x.data_ptr(), gate_r.data_ptr(), gate_i.data_ptr(),
             a_param.data_ptr(), None if h0 is None else h0.data_ptr(),
             carry.data_ptr(), y.data_ptr(), h_out.data_ptr(), B, S, D,
             stream), "rglru")
    return y, h_out
