"""B7 · RMSNorm: the CUDA C++ kernel ``csrc/rmsnorm.cu`` and its plain
version.

Replaces ``repro/kernels/rmsnorm/kernel.py:21`` ``_rmsnorm_kernel`` /
``:28`` ``rmsnorm``: ``y = x · rsqrt(mean x² + eps) · (1 + w)`` in fp32,
cast back to the input type.  The kernel gives each row one block and
folds the row's sum of squares in a fixed order (see the source for the
design and its bound).  The model's ``rms_norm`` launches it when the
plan has ``use_fused_rmsnorm``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import count, on_cuda, report_work

_DTYPES = (torch.bfloat16, torch.float32)


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, *,
                  eps: float = 1e-6) -> torch.Tensor:
    """``x · rsqrt(mean x² + eps) · (1 + w)`` over the last axis, in fp32."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def work(x: torch.Tensor, w: torch.Tensor) -> Tuple[int, int]:
    """(operations, least bytes) of one call: 4 operations an element (the
    square and its sum, the scale, the weight), x read and y written
    once, w read once."""
    return (4 * x.numel(),
            2 * x.numel() * x.element_size() + w.numel() * w.element_size())


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of ``x`` (..., D) with the fp32 weight ``w`` (D,); on meta
    tensors an empty output, and nothing launched."""
    if not on_cuda(x, w, meta=True):
        return rmsnorm_plain(x, w, eps=eps)
    from .build import check, cuda_library
    d = x.shape[-1]
    if x.dtype not in _DTYPES or w.dtype != torch.float32:
        raise TypeError(f"rmsnorm kernel takes bfloat16/float32 x and a "
                        f"float32 w, got {x.dtype}, {w.dtype}")
    if w.shape != (d,):
        raise ValueError(f"rmsnorm: w {tuple(w.shape)} for x "
                         f"{tuple(x.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm kernel takes contiguous tensors")
    y = torch.empty_like(x)
    report_work("rmsnorm", *work(x, w))
    if y.is_meta:
        return y
    rows = x.numel() // d if d else 0
    fn = (cuda_library().cello_rmsnorm_bf16 if x.dtype == torch.bfloat16
          else cuda_library().cello_rmsnorm_f32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    count("rmsnorm")
    check(fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d, float(eps),
             stream), "rmsnorm")
    return y
