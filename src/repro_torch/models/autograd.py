"""B5–B9 under autograd: five ``torch.autograd.Function``s that the
model calls wherever it runs a kernel (B5–B7 where the plan turns the
kernel on, B8 and B9 in every recurrent sequence form).  Outside grad
mode, or where no input needs a gradient (prefill and decode), ``apply``
only runs the forward, so serving and training share this one path.

The kernel wrappers write through ``ctypes`` into tensors that autograd
knows nothing of, so a loss computed through them would backpropagate
past every weight of attention, MLP, norm and recurrence without a
gradient.  Each Function's forward calls the wrapper as serving does (the
hand-written kernel for tensors on the card, its plain version on the
CPU) and keeps its inputs; its backward recomputes a differentiable form
of the same function from those inputs under ``torch.enable_grad()`` and
returns ``torch.autograd.grad`` of it:

* ``FlashAttentionFn`` (B5) — ``attention.chunked_flash_attention`` with
  the plan's ``kv_block``, causal flag and window;
* ``FusedMLPFn`` (B6) — :func:`plain_mlp`, the model's plain MLP: bf16
  products of ``bf16(w)`` with an fp32 activation;
* ``RMSNormFn`` (B7) — ``common.rms_norm``;
* ``RGLRUFn`` (B8) — ``kernels.rglru.rglru_plain``, B8's chunked scan
  (``CHUNK`` 64 steps): S/64 serial steps and a 64-step scan over every
  chunk at once, where the JAX package's ``lax.scan`` reference takes S
  serial steps;
* ``WKV6Fn`` (B9) — ``kernels.rwkv6.wkv6_plain``, B9's chunked form
  (``CHUNK`` 16 steps): products within a chunk, only the chunk-to-chunk
  state pass serial.

The recurrences' chunked forms are the function of the JAX package's
sequential references (``repro/kernels/rglru/ref.py``, ``rwkv6/ref.py``)
summed in another order, and differentiate as well as those do: every
step is a product, a sum or an ``exp`` (decays as products, never
quotients), so the backward has no division to lose accuracy in, and its
graph is S/CHUNK times shorter than a scan's.  Their final states get no
gradient from a loss; the backward takes a missing one as zero.

B5–B7's are the forms the JAX package differentiates: its ``jax.grad``
cannot pass through its own Pallas kernels (none has a ``custom_vjp``),
so off the TPU its training step runs and differentiates exactly these
plain forms.  The gradient here is therefore the gradient of the function
JAX differentiates, taken at the kernel's forward inputs.  The forward
values differ from that form's only by the roundings that the serving
paths' ``LLM_TOL`` admits (B6 multiplies the fp32 weights in 3×TF32
where the plain MLP rounds them to bf16; B5 splits P in two bf16 halves
where the plain form rounds it once).  No backward kernel is written:
the JAX package has none to port.
"""
from __future__ import annotations

from typing import Optional

import torch

from .attention import chunked_flash_attention, flash_attention_bshe
from .common import COMPUTE_DTYPE, activation_fn, bf16, rms_norm

#: the kernel's activation name for each ``cfg.activation``
ACT_NAMES = {"swiglu": "silu", "geglu": "gelu", "relu2": "relu2",
             "gelu": "gelu"}


def plain_mlp(xc: torch.Tensor, w_gate: Optional[torch.Tensor],
              w_up: torch.Tensor, w_down: torch.Tensor, activation: str,
              hidden=lambda h: h) -> torch.Tensor:
    """The plain MLP on compute-dtype rows ``xc``: ``act(xc·bf16(Wg)) ⊙
    (xc·bf16(Wu)) · bf16(Wd)``, the activation in fp32 (``act(xc·bf16(Wu))
    · bf16(Wd)`` without a gate).  ``hidden`` sees the hidden tensor before
    the down product (the model tags it ``mlp_hidden`` there)."""
    act = activation_fn(activation)
    up = xc @ bf16(w_up)
    if w_gate is not None:
        g = xc @ bf16(w_gate)
        h = act(g.to(torch.float32)).to(COMPUTE_DTYPE) * up
    else:
        h = act(up.to(torch.float32)).to(COMPUTE_DTYPE)
    return hidden(h) @ bf16(w_down)


def _grads(ctx, form, inputs, grad_out):
    """Gradients of ``form(*inputs)`` against ``grad_out``, for the inputs
    that need one (None for the others).  A form of several outputs takes
    a tuple ``grad_out``; an output whose gradient is None is left out."""
    need = ctx.needs_input_grad[:len(inputs)]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) if t is not None else None
                  for t, n in zip(inputs, need)]
        wanted = [t for t, n in zip(leaves, need) if n]
        outs = form(*leaves)
        if not isinstance(outs, tuple):
            outs, grad_out = (outs,), (grad_out,)
        pairs = [(o, g) for o, g in zip(outs, grad_out) if g is not None]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                       [g for _, g in pairs])
                   if wanted and pairs else
                   [torch.zeros_like(t) for t in wanted])
    return tuple(next(got) if n else None for n in need)


class FlashAttentionFn(torch.autograd.Function):
    """B5: q ``(B, S, H, E)``, k and v ``(B, T, KVH, E)`` -> ``(B, S, H,
    E)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int],
                kv_block: int):
        ctx.save_for_backward(q, k, v)
        ctx.form = dict(causal=causal, window=window, kv_block=kv_block)
        return flash_attention_bshe(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, grad_out):
        form = ctx.form
        grads = _grads(ctx, lambda q, k, v: chunked_flash_attention(
            q, k, v, **form), ctx.saved_tensors, grad_out)
        return grads + (None, None, None)


class FusedMLPFn(torch.autograd.Function):
    """B6: rows ``x`` ``(M, D)`` in the compute dtype, fp32 weights
    (``w_gate`` None without a gate) -> ``(M, D)``."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down, activation: str):
        from ..kernels.fused_mlp import fused_mlp
        ctx.save_for_backward(x, w_gate, w_up, w_down)
        ctx.activation = activation
        return fused_mlp(x, w_gate, w_up, w_down,
                         activation=ACT_NAMES[activation])

    @staticmethod
    def backward(ctx, grad_out):
        act = ctx.activation
        grads = _grads(ctx, lambda x, g, u, d: plain_mlp(x, g, u, d, act),
                       ctx.saved_tensors, grad_out)
        return grads + (None,)


class RMSNormFn(torch.autograd.Function):
    """B7: ``x`` ``(..., D)``, fp32 ``w`` ``(D,)`` -> ``x``'s shape and
    dtype."""

    @staticmethod
    def forward(ctx, x, w, eps: float):
        from ..kernels.rmsnorm import rmsnorm
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm(x, w, eps=eps)

    @staticmethod
    def backward(ctx, grad_out):
        eps = ctx.eps
        grads = _grads(ctx, lambda x, w: rms_norm(x, w, eps),
                       ctx.saved_tensors, grad_out)
        return grads + (None,)


class RGLRUFn(torch.autograd.Function):
    """B8: x, gate_r, gate_i ``(B, S, D)`` of one dtype, fp32 ``a_param``
    ``(D,)``, fp32 ``h0`` ``(B, D)`` or None -> (h ``(B, S, D)`` in x's
    dtype, hT ``(B, D)`` fp32)."""

    @staticmethod
    def forward(ctx, x, gate_r, gate_i, a_param, h0):
        from ..kernels.rglru import rglru
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, gate_r, gate_i, a_param, h0)
        return rglru(x, gate_r, gate_i, a_param, h0)

    @staticmethod
    def backward(ctx, grad_h, grad_hT):
        from ..kernels.rglru import rglru_plain
        return _grads(ctx, rglru_plain, ctx.saved_tensors,
                      (grad_h, grad_hT))


class WKV6Fn(torch.autograd.Function):
    """B9: r, k, v ``(B, H, S, E)`` of one dtype, fp32 w ``(B, H, S, E)``
    and u ``(H, E)``, fp32 s0 ``(B, H, E, E)`` or None -> (y in r's dtype
    and shape, sT ``(B, H, E, E)`` fp32)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        from ..kernels.rwkv6 import wkv6
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u, s0)
        return wkv6(r, k, v, w, u, s0)

    @staticmethod
    def backward(ctx, grad_y, grad_sT):
        from ..kernels.rwkv6 import wkv6_plain
        return _grads(ctx, wkv6_plain, ctx.saved_tensors,
                      (grad_y, grad_sT))
