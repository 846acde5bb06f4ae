"""B5, B6 and B7 under autograd: three ``torch.autograd.Function``s that
the model calls wherever the plan turns the kernel on.  Outside grad
mode, or where no input needs a gradient (prefill and decode), ``apply``
only runs the forward, so serving and training share this one path.

The kernel wrappers write through ``ctypes`` into tensors that autograd
knows nothing of, so a loss computed through them would backpropagate
past every weight of attention, MLP and norm without a gradient.  Each
Function's forward calls the wrapper as serving does (the hand-written
kernel for tensors on the card, its plain version on the CPU) and keeps
its inputs; its backward recomputes a differentiable form of the same
function from those inputs under ``torch.enable_grad()`` and returns
``torch.autograd.grad`` of it:

* ``FlashAttentionFn`` (B5) — ``attention.chunked_flash_attention`` with
  the plan's ``kv_block``, causal flag and window;
* ``FusedMLPFn`` (B6) — :func:`plain_mlp`, the model's plain MLP: bf16
  products of ``bf16(w)`` with an fp32 activation;
* ``RMSNormFn`` (B7) — ``common.rms_norm(..., fused=False)``.

These are the forms the JAX package differentiates: its ``jax.grad``
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
    that need one (None for the others)."""
    need = ctx.needs_input_grad[:len(inputs)]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) if t is not None else None
                  for t, n in zip(inputs, need)]
        wanted = [t for t, n in zip(leaves, need) if n]
        got = iter(torch.autograd.grad(form(*leaves), wanted, grad_out)
                   if wanted else ())
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
