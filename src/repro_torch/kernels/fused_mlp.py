"""B6 · fused MLP: the CUDA C++ kernels ``csrc/fused_mlp.cu`` and their
plain version.

Replaces ``repro/kernels/fused_mlp/kernel.py:37`` ``_mlp_kernel_gated``,
``:59`` ``_mlp_kernel_plain`` and ``:78`` ``fused_mlp`` (with ``ops.py``
and ``ref.py``): ``act(x·Wg)·(x·Wu)·Wd``, or ``act(x·Wu)·Wd`` without a
gate, act one of silu, tanh-gelu or relu², on the fp32 weights with fp32
accumulation, cast to x's dtype once.  The kernels split F into chunks
whose fp32 parts of the output are summed in ascending chunk order, in two
launches: the hidden tensor (x's rows × F, fp32) to a scratch buffer, then
the down product, whose blocks each own an output tile and add every
chunk's part to it in order (see the source for the design and its
bound).  One call counts one launch.

Two regimes (``launch_shape``): from 17 rows up the products run on the
tensor cores in the 3×TF32 split (``matmul_3xtf32``: each fp32 operand as a
TF32 high part and a TF32 remainder; a bf16 x is exact in TF32 and takes two
terms, an fp32 x three); up to 16 rows, a decode step, in exact fp32 on the
CUDA cores.  The plain version repeats the regime's arithmetic.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import count, on_cuda

#: activation name -> the kernel's code
ACTIVATIONS = {"silu": 0, "gelu": 1, "relu2": 2}
_DTYPES = (torch.bfloat16, torch.float32)


def _act(h: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return h * torch.sigmoid(h)
    if kind == "gelu":
        return F.gelu(h, approximate="tanh")
    if kind == "relu2":
        r = torch.relu(h)
        return r * r
    raise ValueError(kind)


#: the tensor-core (3×TF32) kernel from this many rows up; fewer rows run
#: the exact fp32 rows kernel
TC_MIN_ROWS = 17


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """fp32 ``t`` rounded to TF32's 10-bit mantissa, to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` (low 13 bits zero)."""
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(t: torch.Tensor):
    """``(hi, lo)``: ``t`` rounded to TF32 and the remainder rounded to
    TF32."""
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor,
                  terms: int = 3) -> torch.Tensor:
    """``a @ b`` for fp32 ``a``, ``b`` as the kernel takes it: ``a_lo·b_hi +
    a_hi·b_lo + a_hi·b_hi`` (``terms=3``), or ``a·b_lo + a·b_hi`` when ``a``
    is exact in TF32 (``terms=2``: a bf16 x).  Each product of TF32 values
    is exact in fp32; the sums are fp32."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    if terms == 2:
        return a_hi @ b_lo + a_hi @ b_hi
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def fused_mlp_plain(x: torch.Tensor, w_gate: Optional[torch.Tensor],
                    w_up: torch.Tensor, w_down: torch.Tensor, *,
                    activation: str = "silu") -> torch.Tensor:
    """``(act(x·Wg) ⊙ (x·Wu))·Wd`` (``act(x·Wu)·Wd`` when ``w_gate`` is None)
    with fp32 accumulation, in x's dtype: the products in the 3×TF32 split
    from ``TC_MIN_ROWS`` rows up (two terms for a bf16 x), exact fp32 below."""
    xf = x.float()
    if xf.numel() // max(x.shape[-1], 1) >= TC_MIN_ROWS:
        terms = 2 if x.dtype == torch.bfloat16 else 3

        def up(w):
            return matmul_3xtf32(xf, w.float(), terms)

        def down(h):
            return matmul_3xtf32(h, w_down.float())
    else:
        def up(w):
            return xf @ w.float()

        def down(h):
            return h @ w_down.float()
    if w_gate is not None:
        h = _act(up(w_gate), activation) * up(w_up)
    else:
        h = _act(up(w_up), activation)
    return down(h).to(x.dtype)


def launch_shape(m: int, f: int):
    """(block_m, hidden columns per chunk) for ``m`` token rows and ``f``
    hidden columns.  From ``TC_MIN_ROWS`` up, the tensor-core kernel: 64
    rows × 256 columns.  Below, the rows kernels with rows padded to 4 or
    16 and 64-column chunks, or 32 where F/64 would give fewer than 200
    blocks, so that two or more hidden blocks run on each of the 132
    SMs."""
    if m >= TC_MIN_ROWS:
        return 64, 256
    return (4 if m <= 4 else 16), (64 if f >= 64 * 200 else 32)


def fused_mlp(x: torch.Tensor, w_gate: Optional[torch.Tensor],
              w_up: torch.Tensor, w_down: torch.Tensor, *,
              activation: str = "silu") -> torch.Tensor:
    """x ``(..., D)``; w_gate, w_up ``(D, F)``; w_down ``(F, D)``.  Returns
    ``(..., D)`` in x's dtype."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation {activation!r} not in "
                         f"{sorted(ACTIVATIONS)}")
    weights = [w for w in (w_gate, w_up, w_down) if w is not None]
    if not on_cuda(x, *weights):
        return fused_mlp_plain(x, w_gate, w_up, w_down, activation=activation)
    from .build import check, cuda_library
    d = x.shape[-1]
    f = w_up.shape[1]
    if x.dtype not in _DTYPES or any(w.dtype != torch.float32
                                     for w in weights):
        raise TypeError(f"fused_mlp kernel takes bfloat16/float32 x and "
                        f"float32 weights, got x {x.dtype}, weights "
                        f"{[w.dtype for w in weights]}")
    if (w_up.shape != (d, f) or w_down.shape != (f, d)
            or (w_gate is not None and w_gate.shape != (d, f))):
        raise ValueError(f"fused_mlp: x {tuple(x.shape)}, w_up "
                         f"{tuple(w_up.shape)}, w_down {tuple(w_down.shape)}"
                         + ("" if w_gate is None
                            else f", w_gate {tuple(w_gate.shape)}"))
    if not (x.is_contiguous() and all(w.is_contiguous() for w in weights)):
        raise ValueError("fused_mlp kernel takes contiguous tensors")
    if d % 8 or f % 4 or any(t.data_ptr() % 16 for t in (x, *weights)):
        raise ValueError(f"fused_mlp kernel copies 16-byte vectors: it takes "
                         f"D a multiple of 8 (got {d}), F a multiple of 4 "
                         f"(got {f}) and 16-byte aligned tensors")
    m = x.numel() // d if d else 0
    block_m, chunk = launch_shape(m, f)
    lib = cuda_library()
    hidden = torch.empty((m, f), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    fn = (lib.cello_fused_mlp_bf16 if x.dtype == torch.bfloat16
          else lib.cello_fused_mlp_f32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    count("fused_mlp")
    check(fn(x.data_ptr(), None if w_gate is None else w_gate.data_ptr(),
             w_up.data_ptr(), w_down.data_ptr(), hidden.data_ptr(),
             out.data_ptr(), m, d, f, chunk, block_m,
             ACTIVATIONS[activation], stream), "fused_mlp")
    return out
