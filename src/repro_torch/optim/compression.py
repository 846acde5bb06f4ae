"""Gradient compression (int8 with error feedback) for slow cross-pod links.

The counterpart of ``repro.optim.compression`` on the port's tree:
symmetric per-tensor int8 quantisation (round half to even, as
``jnp.round``) with a fp32 scale, and error feedback that carries each
leaf's quantisation residual into the next step.  The compressed
all-reduce across pods that would use it comes with the LLM mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
import torch.utils._pytree as pytree

Tree = Any


@dataclasses.dataclass
class CompressionState:
    error: Tree          # residual feedback buffer, same structure as grads

    @staticmethod
    def init(grads_like: Tree) -> "CompressionState":
        return CompressionState(error=pytree.tree_map(
            lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device), grads_like))


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation. Returns (q, scale)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def error_feedback_compress(grads: Tree, state: CompressionState
                            ) -> Tuple[Tree, Tree, CompressionState]:
    """Quantise (grads + carried error); return (q_tree, scale_tree,
    state'), the new state holding what the quantisation lost."""
    flat_g, spec = pytree.tree_flatten(grads)
    qs, scales, errors = [], [], []
    for g, e in zip(flat_g, pytree.tree_leaves(state.error)):
        corrected = g.float() + e
        q, scale = compress_int8(corrected)
        qs.append(q)
        scales.append(scale)
        errors.append(corrected - decompress_int8(q, scale))
    return (pytree.tree_unflatten(qs, spec),
            pytree.tree_unflatten(scales, spec),
            CompressionState(error=pytree.tree_unflatten(errors, spec)))
