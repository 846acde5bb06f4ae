"""B8 · RG-LRU scan: the CUDA C++ kernel ``csrc/rglru.cu`` and its plain
version.

Replaces ``repro/kernels/rglru/kernel.py:27`` ``_rglru_kernel`` / ``:48``
``rglru`` (with ``ref.py``'s semantics): per channel,
``a = exp(−8·softplus(Λ)·σ(g_r))`` and ``h = a·h + sqrt(max(1 − a², 1e-12))
·(σ(g_i)·x)`` over time, in fp32; y in x's type, the final state in fp32.
The kernel gives each (batch row, channel) one thread that carries h in a
register across the sequence (see the source for the design and its
bound).  ``models.recurrent.apply_rglru_seq`` launches
it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import count, on_cuda

#: the RG-LRU's fixed scale of the log decay (``RGLRU_C``)
RGLRU_C = 8.0
_DTYPES = (torch.bfloat16, torch.float32)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``'s form, ``log1p(exp(−|x|)) + max(x, 0)`` (torch's
    ``F.softplus`` switches to x above a threshold and rounds otherwise)."""
    return torch.log1p(torch.exp(-x.abs())) + torch.clamp_min(x, 0.0)


def rglru_plain(x: torch.Tensor, gate_r: torch.Tensor, gate_i: torch.Tensor,
                a_param: torch.Tensor, h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX reference's arithmetic, a Python loop over t.  x, gate_r,
    gate_i: (B, S, D); a_param: (D,); h0: (B, D) or None.  Returns (y
    (B, S, D) in x's dtype, hT (B, D) fp32)."""
    B, S, D = x.shape
    xf = x.float()
    r = torch.sigmoid(gate_r.float())
    i = torch.sigmoid(gate_i.float())
    a = torch.exp(-RGLRU_C * softplus(a_param.float()) * r)
    gated_x = i * xf
    beta = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12))
    h = (torch.zeros((B, D), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    y = torch.empty((B, S, D), dtype=x.dtype, device=x.device)
    for t in range(S):
        h = a[:, t] * h + beta[:, t] * gated_x[:, t]
        y[:, t] = h
    return y, h


def rglru(x: torch.Tensor, gate_r: torch.Tensor, gate_i: torch.Tensor,
          a_param: torch.Tensor, h0: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU scan of ``x`` (B, S, D) under the gates' pre-activations
    (x's dtype and shape), the fp32 ``a_param`` (D,) and the optional fp32
    initial state ``h0`` (B, D).  Returns (y, hT)."""
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
    fn = (cuda_library().cello_rglru_bf16 if x.dtype == torch.bfloat16
          else cuda_library().cello_rglru_f32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    count("rglru")
    check(fn(x.data_ptr(), gate_r.data_ptr(), gate_i.data_ptr(),
             a_param.data_ptr(), None if h0 is None else h0.data_ptr(),
             y.data_ptr(), h_out.data_ptr(), B, S, D, stream), "rglru")
    return y, h_out
