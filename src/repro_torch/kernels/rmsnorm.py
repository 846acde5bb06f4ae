"""B7 · RMSNorm: the CUDA C++ kernel ``csrc/rmsnorm.cu`` and its plain
version.

Replaces ``repro/kernels/rmsnorm/kernel.py:21`` ``_rmsnorm_kernel`` /
``:28`` ``rmsnorm``: ``y = x · rsqrt(mean x² + eps) · (1 + w)`` in fp32,
cast back to the input type.  The kernel gives each row a group of
threads sized by the width (:func:`launch_shape`), reads the row once
from 16-byte vectors held in registers, keeps ``1 + w`` in registers for
every row its CTA covers, and folds the row's sum of squares in an order
fixed by (D, dtype) (see the source for the design and its bound).  A row
wider than a CTA's registers hold is walked in chunks: any width runs.  The
model's ``rms_norm`` launches it when the plan has ``use_fused_rmsnorm``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from . import count, on_cuda, report_work

_DTYPES = (torch.bfloat16, torch.float32)

#: the vectors a thread may own; ``csrc/rmsnorm.cu::dispatch``
#: instantiates each
VECTORS = (1, 2, 3, 4, 5, 6, 8)
#: a CTA's threads at most (``kMaxThreads`` in the source)
MAX_THREADS = 256
#: the vector path's aim: a row group of about 128 threads, 2-6 vectors a
#: thread where the width allows, and a CTA of at least 128 threads (the
#: fastest rule over every (G, V, R) at phase 3's widths on an H100:
#: ``scripts/b7_shapes.py``, PERF.md §6)
GROUP_THREADS, GROUP_VECTORS = 128, range(2, 7)


class LaunchShape(NamedTuple):
    """``threads`` a row (G, a multiple of 32), ``vectors`` of 16 bytes a
    thread (V), ``rows`` a CTA (R), and ``vector``: the 16-byte path
    (G·V·(16 / itemsize) = D), else the general one (scalar loads masked
    past D, G·V·(16 / itemsize) ≥ D)."""
    threads: int
    vectors: int
    rows: int
    vector: bool


@functools.lru_cache(maxsize=None)
def launch_shape(d: int, dtype: torch.dtype) -> LaunchShape:
    """The row group for width ``d``.  Where G threads of V vectors cover
    the row exactly, the vector path: of those (G, V), the G nearest
    ``GROUP_THREADS`` (the larger on a tie), among the V of
    ``GROUP_VECTORS`` where one is.  Otherwise (or where ``d`` is no
    multiple of the 16-byte vector) the general path: one row a CTA of
    ``MAX_THREADS`` threads, each with the least V that covers the row
    (G near the row's vectors was up to 1.5x slower in bf16,
    ``scripts/b7_shapes.py``), or the largest V where none does: the
    kernel then walks the row in chunks of ``MAX_THREADS`` x V vectors,
    on 16-byte loads where ``d`` is a multiple of the vector (``vector``).  On the vector path R row groups make a
    CTA of ``GROUP_THREADS`` or, with G above it, one row group.  Cached:
    the wrapper asks at every launch."""
    per = 16 // dtype.itemsize
    slots = -(-d // per)
    exact = [(slots // v, v) for v in VECTORS
             if d % per == 0 and slots % v == 0 and (slots // v) % 32 == 0
             and slots // v <= MAX_THREADS]
    if exact:
        pool = [s for s in exact if s[1] in GROUP_VECTORS] or exact
        g, v = min(pool, key=lambda s: (abs(s[0] - GROUP_THREADS), -s[0]))
        return LaunchShape(g, v, max(1, GROUP_THREADS // g), True)
    fits = [v for v in VECTORS if v * MAX_THREADS >= slots]
    if fits:
        return LaunchShape(MAX_THREADS, fits[0], 1, False)
    # past a CTA's registers: walked in chunks, on 16-byte vectors where
    # the width is a multiple of one
    return LaunchShape(MAX_THREADS, max(VECTORS), 1, d % per == 0)


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
    tensors an empty output, and nothing launched.  On the card an
    operand that is not 16-byte aligned takes the general path."""
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
    g, v, r, vec = launch_shape(max(d, 1), x.dtype)
    rows = x.numel() // d if d else 0
    fn = (cuda_library().cello_rmsnorm_bf16 if x.dtype == torch.bfloat16
          else cuda_library().cello_rmsnorm_f32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    count("rmsnorm")
    # the C entry sends an operand that is not 16-byte aligned to the
    # general path
    check(fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d, g, v, r,
             int(vec), float(eps), stream), "rmsnorm")
    return y
