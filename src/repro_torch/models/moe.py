"""Top-k MoE FFN with grouped, capacity-bounded dispatch.

The counterpart of ``repro.models.moe`` on one device, with the JAX
package's semantics: tokens are viewed as ``(G, Tg)`` groups (``G`` = 1
here: ``_n_groups`` of the JAX package is 1 without a mesh); routing runs
in fp32 (``top_k`` over the softmax, the gates renormalised); each
(token, k) pair takes the next slot of its expert in token-major order,
the expert's count of earlier pairs (a cumsum over the one-hot of the
routes); pairs past the capacity ``C = max(top_k, int(Tg·top_k·
capacity_factor) // E)`` are dropped and contribute zero; the experts
compute in bf16.

The expert products are three batched matmuls over the (E, C, ·) dispatch
buffer, as the JAX package's einsums are: no Pallas kernel computes them
there, so none does here.  Nothing in ``apply_moe`` reads a device value
on the host (no ``nonzero``, boolean-mask indexing or ``.item()``), so a
decode step through it can be captured in a CUDA graph: the buffer is
filled with ``index_copy_`` and read back by gather, with every dropped
pair sent to a spare block that is never read.  ``expert_share`` is that
body for a range of experts, so that a mesh's model slots
(``models.sharded``) each run their experts' share of it.

Under autograd the same ops carry the JAX package's gradients: the
router's through the renormalised gates (``topk`` passes its values'
gradient to the softmax), a kept pair's input through the buffer
(``index_copy_``'s backward gathers the rows it wrote; the spare block is
sliced off, so a dropped pair gets zero, as JAX's ``where(keep, ·, 0)``
gives it) and the experts' outputs through the combine gather.  The
router logits and the experts' hidden tensor carry the JAX package's
remat tags, ``router_logits`` and ``mlp_hidden``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from .common import (COMPUTE_DTYPE, PARAM_DTYPE, activation_fn, bf16,
                     dense_init, is_gated, tag)


def init_moe_params(gen: torch.Generator, d_model: int, d_ff: int,
                    n_experts: int, activation: str, *, device,
                    dtype=PARAM_DTYPE) -> Dict[str, torch.Tensor]:
    """The router ``(D, E)`` and the experts' ``(E, D, F)`` / ``(E, F, D)``
    weights, with the JAX package's shapes and scales."""
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5
    p = {
        "w_router": dense_init(gen, (d_model, n_experts), s_in, device,
                               dtype),
        "w_up": dense_init(gen, (n_experts, d_model, d_ff), s_in, device,
                           dtype),
        "w_down": dense_init(gen, (n_experts, d_ff, d_model), s_out, device,
                             dtype),
    }
    if is_gated(activation):
        p["w_gate"] = dense_init(gen, (n_experts, d_model, d_ff), s_in,
                                 device, dtype)
    return p


def moe_pspecs(activation: str) -> Dict[str, tuple]:
    """Logical PartitionSpec per param (expert axis on "model")."""
    specs = {"w_router": (None, None), "w_up": ("model", None, None),
             "w_down": ("model", None, None)}
    if is_gated(activation):
        specs["w_gate"] = ("model", None, None)
    return specs


class Routing(NamedTuple):
    """Where each (token, k) pair goes, in token-major order ``t·top_k +
    k``: ``gates`` (T, top_k) fp32, ``idx`` (T, top_k) its expert,
    ``slot`` (T·top_k,) its place in the expert's buffer, clipped to
    ``[0, C)``, and ``keep`` (T·top_k,) whether it fits the capacity."""
    gates: torch.Tensor
    idx: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    capacity: int


def capacity(tokens: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Slots per expert for a group of ``tokens`` tokens."""
    return max(top_k, int(tokens * top_k * capacity_factor) // n_experts)


def route(w_router: torch.Tensor, x: torch.Tensor, *, top_k: int,
          capacity_factor: float) -> Routing:
    """The routing of ``x`` (T, D): fp32 logits and softmax, ``top_k``
    experts a token, their gates renormalised, and each pair's slot."""
    T = x.shape[0]
    E = w_router.shape[1]
    C = capacity(T, E, top_k, capacity_factor)
    logits = tag(x.to(torch.float32) @ w_router.to(torch.float32),
                 "router_logits")
    gates, idx = torch.topk(torch.softmax(logits, dim=-1), top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    flat_e = idx.reshape(T * top_k)
    onehot = (flat_e[:, None] == torch.arange(E, device=x.device)
              ).to(torch.int32)                                # (T*k, E)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1   # (T*k,)
    keep = (pos >= 0) & (pos < C)
    return Routing(gates, idx, torch.clamp(pos, 0, C - 1), keep, C)


def expert_share(params: Dict[str, torch.Tensor], x: torch.Tensor,
                 r: Routing, *, activation: str, first: int = 0,
                 n_local: Optional[int] = None) -> torch.Tensor:
    """The experts ``[first, first + n_local)``'s share of the FFN on
    routes ``r``: the (token, k) pairs routed to them dispatched into
    their buffer, their products, and the combine's gated products
    ``(T, top_k, D)`` in bf16, zero for the pairs they do not hold.
    ``params`` holds those experts' weights (all ``E`` of them by
    default).  ``apply_moe`` sums it over k; ``models.sharded`` sums the
    model slots' shares first, each slot holding ``E/TP`` experts."""
    T, D = x.shape
    top_k = r.idx.shape[1]
    C = r.capacity
    if n_local is None:
        n_local = params["w_up"].shape[0]
    act = activation_fn(activation)
    flat_e = r.idx.reshape(T * top_k)
    mine = (flat_e >= first) & (flat_e < first + n_local)
    held = mine & r.keep
    e_loc = torch.where(mine, flat_e - first, torch.zeros_like(flat_e))

    # dispatch: pair t·k + j lands in row (expert, slot) of the buffer; a
    # pair not held here lands in the spare block past the experts' rows,
    # which is never read, so every held row is written once and the copy
    # is exact
    row = torch.where(held, e_loc * (C + 1) + r.slot,
                      torch.full_like(r.slot, n_local * (C + 1)))
    xk = x.to(COMPUTE_DTYPE).repeat_interleave(top_k, dim=0)  # (T*k, D)
    buf = torch.zeros(((n_local + 1) * (C + 1), D), dtype=COMPUTE_DTYPE,
                      device=x.device)
    buf.index_copy_(0, row, xk)
    buf = buf.view(n_local + 1, C + 1, D)[:n_local, :C]       # (E, C, D)

    # the experts, batched over E
    up = torch.bmm(buf, bf16(params["w_up"]))
    if is_gated(activation):
        g = torch.bmm(buf, bf16(params["w_gate"]))
        h = act(g.to(torch.float32)).to(COMPUTE_DTYPE) * up
    else:
        h = act(up.to(torch.float32)).to(COMPUTE_DTYPE)
    h = tag(h, "mlp_hidden")
    out_buf = torch.bmm(h, bf16(params["w_down"]))             # (E, C, D)

    # combine: each held pair reads its row back, the others give zero
    y = out_buf[e_loc, r.slot]                                 # (T*k, D)
    y = torch.where(held[:, None], y, torch.zeros_like(y))
    return y.reshape(T, top_k, D) * r.gates[..., None].to(COMPUTE_DTYPE)


def apply_moe(params: Dict[str, torch.Tensor], x: torch.Tensor, *,
              top_k: int, activation: str,
              capacity_factor: float = 1.25) -> torch.Tensor:
    """x: (tokens, d_model) -> (tokens, d_model), in x's dtype."""
    r = route(params["w_router"], x, top_k=top_k,
              capacity_factor=capacity_factor)
    y = expert_share(params, x, r, activation=activation)
    return y.sum(dim=1).to(x.dtype)
