"""Recurrent blocks: RG-LRU (recurrentgemma) and RWKV-6 time-mix.

The counterpart of ``repro.models.recurrent``.  Both expose a
full-sequence form (prefill and training) and a single-step form (decode)
that carries the recurrent state, and the logical PartitionSpecs of
their parameters (``rglru_pspecs``: channels on "model"; ``rwkv_pspecs``:
heads on "model"), which ``models.sharded`` splits them by.  The
scan's output is tagged ``rnn_state`` where the JAX package tags it, so a
remat policy that names it keeps it.

The sequence forms always send the recurrence through the B8
(``kernels.rglru``) and B9 (``kernels.rwkv6``) wrappers, inside their
autograd Functions (``models.autograd.RGLRUFn``, ``WKV6Fn``: the wrapper
forward, the plain chunked form's gradient backward) — the kernel for
tensors on the card, its plain version for tensors on the CPU.  The JAX
signature's ``use_kernel`` flag is thus fixed to True here and is not a
parameter: a CUDA tensor launches the kernel or the wrapper raises.  The
Functions import the wrappers at call time, so swapping the module
attribute (``rglru`` / ``wkv6``) swaps what the model runs.
The single-step forms are plain torch ops, as in the JAX package: no
kernel exists for one step.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..kernels.rglru import RGLRU_C, softplus
from .autograd import RGLRUFn, WKV6Fn
from .common import COMPUTE_DTYPE, bf16, dense_init, tag

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# RG-LRU block (Griffin recurrent block: proj → conv-less gated recurrence)
# ---------------------------------------------------------------------------

def init_rglru_params(gen: torch.Generator, d_model: int, dtype, *,
                      device) -> Params:
    s = d_model ** -0.5
    D = d_model
    a_param = torch.rand((D,), generator=gen, device=device,
                         dtype=torch.float32)
    return {
        "w_x": dense_init(gen, (D, D), s, device, dtype),
        "w_gate_r": dense_init(gen, (D, D), s, device, dtype),
        "w_gate_i": dense_init(gen, (D, D), s, device, dtype),
        "w_out": dense_init(gen, (D, D), s, device, dtype),
        "a_param": a_param.mul_(0.2).add_(0.9),       # uniform [0.9, 1.1)
    }


def rglru_pspecs() -> Dict[str, tuple]:
    # channel dim sharded on "model": the recurrence is elementwise in d
    return {"w_x": (None, "model"), "w_gate_r": (None, "model"),
            "w_gate_i": (None, "model"), "w_out": ("model", None),
            "a_param": ("model",)}


def apply_rglru_seq(params, x: torch.Tensor, h0=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> (y: (B,S,D), hT: (B,D) fp32)."""
    xc = x.to(COMPUTE_DTYPE)
    xb = xc @ bf16(params["w_x"])
    gr = xc @ bf16(params["w_gate_r"])
    gi = xc @ bf16(params["w_gate_i"])
    h, hT = RGLRUFn.apply(xb, gr, gi, params["a_param"], h0)
    h = tag(h, "rnn_state")
    y = h.to(COMPUTE_DTYPE) @ bf16(params["w_out"])
    return y.to(x.dtype), hT


def apply_rglru_step(params, x: torch.Tensor, h: torch.Tensor, *,
                     donate: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,1,D), h: (B,D) -> (y: (B,1,D), h').  ``donate`` writes h' into
    ``h`` in place (the same roundings, so the same bits) and returns it."""
    xc = x[:, 0].to(COMPUTE_DTYPE)
    xb = (xc @ bf16(params["w_x"])).float()
    r = torch.sigmoid((xc @ bf16(params["w_gate_r"])).float())
    i = torch.sigmoid((xc @ bf16(params["w_gate_i"])).float())
    a = torch.exp(-RGLRU_C * softplus(params["a_param"]) * r)
    beta = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12))
    if donate:
        h_new = h.mul_(a).add_(beta * (i * xb))
    else:
        h_new = a * h + beta * (i * xb)
    y = h_new.to(COMPUTE_DTYPE) @ bf16(params["w_out"])
    return y[:, None].to(x.dtype), h_new


# ---------------------------------------------------------------------------
# RWKV-6 time-mix block
# ---------------------------------------------------------------------------

def init_rwkv_params(gen: torch.Generator, d_model: int, n_heads: int, dtype,
                     *, device) -> Params:
    s = d_model ** -0.5
    D, E = d_model, d_model // n_heads
    return {
        "w_r": dense_init(gen, (D, D), s, device, dtype),
        "w_k": dense_init(gen, (D, D), s, device, dtype),
        "w_v": dense_init(gen, (D, D), s, device, dtype),
        "w_w": dense_init(gen, (D, D), s * 0.1, device, dtype),
        "w_o": dense_init(gen, (D, D), s, device, dtype),
        "u": dense_init(gen, (n_heads, E), 0.1, device, torch.float32),
        "w_bias": dense_init(gen, (D,), 0.1, device, torch.float32).sub_(0.5),
    }


def rwkv_pspecs() -> Dict[str, tuple]:
    # head dim sharded on "model" (heads are independent in the recurrence)
    return {"w_r": (None, "model"), "w_k": (None, "model"),
            "w_v": (None, "model"), "w_w": (None, "model"),
            "w_o": ("model", None), "u": ("model", None),
            "w_bias": ("model",)}


def _split_heads(t: torch.Tensor, H: int) -> torch.Tensor:
    """(B,S,D) -> (B,H,S,E), a view (the B9 kernel takes its strides)."""
    B, S, D = t.shape
    return t.reshape(B, S, H, D // H).transpose(1, 2)


def apply_rwkv_seq(params, x: torch.Tensor, n_heads: int, s0=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> (y: (B,S,D), sT: (B,H,E,E) fp32).  ``params`` may
    hold a slot's share of the heads (``n_heads`` of them, the projections'
    columns and ``w_o``'s rows theirs): ``y`` is then that share's part of
    the output."""
    B, S, D = x.shape
    xc = x.to(COMPUTE_DTYPE)
    r = _split_heads(xc @ bf16(params["w_r"]), n_heads)
    k = _split_heads(xc @ bf16(params["w_k"]), n_heads)
    v = _split_heads(xc @ bf16(params["w_v"]), n_heads)
    w = _split_heads((xc @ bf16(params["w_w"])).float()
                     + params["w_bias"].float(), n_heads)
    y, sT = WKV6Fn.apply(r, k, v, w, params["u"], s0)
    y = tag(y, "rnn_state")
    y = y.transpose(1, 2).reshape(B, S, -1)
    out = y.to(COMPUTE_DTYPE) @ bf16(params["w_o"])
    return out.to(x.dtype), sT


def apply_rwkv_step(params, x: torch.Tensor, s: torch.Tensor, n_heads: int,
                    *, donate: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,1,D), s: (B,H,E,E) -> (y: (B,1,D), s').  ``donate`` writes s'
    into ``s`` in place (the same roundings, so the same bits) and returns
    it.  ``params`` may hold a slot's share of the heads, as in
    :func:`apply_rwkv_seq`."""
    B = x.shape[0]
    E = params["u"].shape[-1]
    xc = x[:, 0].to(COMPUTE_DTYPE)
    r = (xc @ bf16(params["w_r"])).reshape(B, n_heads, E)
    k = (xc @ bf16(params["w_k"])).reshape(B, n_heads, E)
    v = (xc @ bf16(params["w_v"])).reshape(B, n_heads, E)
    wt = ((xc @ bf16(params["w_w"])).float()
          + params["w_bias"]).reshape(B, n_heads, E)
    rf, kf, vf = (t.float() for t in (r, k, v))
    decay = torch.exp(-torch.exp(wt))
    kv = kf[..., :, None] * vf[..., None, :]                  # (B,H,E,E)
    y = torch.einsum("bhi,bhij->bhj", rf,
                     s + params["u"][None, :, :, None] * kv)
    if donate:
        s_new = s.mul_(decay[..., :, None]).add_(kv)
    else:
        s_new = decay[..., :, None] * s + kv
    y = y.reshape(B, 1, n_heads * E).to(COMPUTE_DTYPE)
    out = y @ bf16(params["w_o"])
    return out.to(x.dtype), s_new
