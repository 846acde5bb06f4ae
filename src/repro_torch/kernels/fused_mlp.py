"""B6 · fused MLP: the CUDA C++ kernel ``csrc/fused_mlp.cu`` and its plain
version.

Replaces ``repro/kernels/fused_mlp/kernel.py:37`` ``_mlp_kernel_gated``,
``:59`` ``_mlp_kernel_plain`` and ``:78`` ``fused_mlp`` (with ``ops.py``
and ``ref.py``): ``act(x·Wg)·(x·Wu)·Wd``, or ``act(x·Wu)·Wd`` without a
gate, act one of silu, tanh-gelu or relu², computed in fp32 on the fp32
weights and cast to x's dtype once.  The hidden tensor stays on chip: the
kernel splits F into chunks whose fp32 partial outputs a second pass folds
in a fixed order (see the source for the design and its bound).  One call
launches both passes and counts one launch.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import LAUNCHES, on_cuda

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


def fused_mlp_plain(x: torch.Tensor, w_gate: Optional[torch.Tensor],
                    w_up: torch.Tensor, w_down: torch.Tensor, *,
                    activation: str = "silu") -> torch.Tensor:
    """``(act(x·Wg) ⊙ (x·Wu))·Wd`` (``act(x·Wu)·Wd`` when ``w_gate`` is None)
    with fp32 operands and products, in x's dtype."""
    xf = x.float()
    if w_gate is not None:
        h = _act(xf @ w_gate.float(), activation) * (xf @ w_up.float())
    else:
        h = _act(xf @ w_up.float(), activation)
    return (h @ w_down.float()).to(x.dtype)


def launch_shape(m: int):
    """(rows per block, hidden columns per chunk) for ``m`` token rows: 64
    rows and 256-column chunks for a prefill; 16 rows and 128-column chunks
    for a few rows (a decode step), so that F/128 chunks fill the card."""
    return (64, 256) if m > 16 else (16, 128)


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
    m = x.numel() // d if d else 0
    block_m, chunk = launch_shape(m)
    n_chunks = -(-f // chunk)
    partial = torch.empty((n_chunks, m, d), dtype=torch.float32,
                          device=x.device)
    out = torch.empty_like(x)
    fn = (cuda_library().cello_fused_mlp_bf16 if x.dtype == torch.bfloat16
          else cuda_library().cello_fused_mlp_f32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    LAUNCHES["fused_mlp"] += 1
    check(fn(x.data_ptr(), None if w_gate is None else w_gate.data_ptr(),
             w_up.data_ptr(), w_down.data_ptr(), partial.data_ptr(),
             out.data_ptr(), m, d, f, chunk, block_m,
             ACTIVATIONS[activation], stream), "fused_mlp")
    return out
