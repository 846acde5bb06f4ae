"""Shared model utilities: the mesh context, dtype policy, RoPE,
activations, RMSNorm, and the remat tags.

The counterparts of ``repro.models.common``.  Sharding uses *logical*
axis names resolved through a per-thread context (``set_mesh_context``),
or against a mesh passed in (``launch.shardings``), with the JAX package's
table (``repro/models/common.py:29-40``):

    logical axis   single-pod          multi-pod
    "batch"     -> ("data",)        -> ("pod", "data")
    "model"     -> "model"          -> "model"
    "data"      -> ("data",)        -> ("pod", "data")

``pspec`` and ``named_sharding`` build the port's ``PartitionSpec`` and
``NamedSharding`` (``launch.mesh``) from logical names.  ``constrain`` places
nothing: the JAX package hands its constraint to GSPMD, which partitions
the program, while the port has no partitioner — ``models.sharded`` walks
the mesh's slots itself, each slot computing on its own shards — so here
it only checks the logical axes against the tensor's shape and returns
the tensor.

``tag`` is the counterpart of ``checkpoint_name``: an identity op
(``repro_torch::tag``, registered with ``torch.library``) that carries a
name, so that a :class:`RematPolicy` (``CelloPlan.checkpoint_policy()``)
can keep exactly the named tensors through selective activation
checkpointing and recompute the rest.
"""
from __future__ import annotations

import threading
from typing import Iterable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32

_CTX = threading.local()


# ---------------------------------------------------------------------------
# mesh context
# ---------------------------------------------------------------------------

def logical_axes(mesh) -> dict:
    """The table above for ``mesh``'s axis names: each logical axis's
    mesh axes (None where the mesh lacks them)."""
    data = mesh.data_axes or None
    return {"batch": data, "data": data,
            "model": "model" if "model" in mesh.axis_names else None}


def set_mesh_context(mesh) -> None:
    """Make ``mesh`` (a ``launch.mesh.DeviceMesh``, or None) the calling
    thread's mesh, and resolve the logical axes against its names."""
    _CTX.mesh = mesh
    _CTX.axes = {} if mesh is None else logical_axes(mesh)


def get_mesh():
    return getattr(_CTX, "mesh", None)


def resolve_axis(name, mesh=None):
    """The mesh axes of the logical axis ``name`` under the calling
    thread's mesh (None outside the table), or under ``mesh`` when one is
    given: then a name outside the table is already mesh axes (a ZeRO-1
    spec's ``("data",)``) and passes as it is, as ``launch.shardings``
    resolves spec trees."""
    if name is None:
        return None
    if mesh is None:
        return getattr(_CTX, "axes", {}).get(name)
    return logical_axes(mesh).get(name, name)


def pspec(*logical):
    """The ``PartitionSpec`` of the logical axes under the current mesh."""
    from ..launch.mesh import PartitionSpec
    return PartitionSpec(*(resolve_axis(a) for a in logical))


def constrain(x: torch.Tensor, *logical) -> torch.Tensor:
    """``x``, unchanged (see the module docstring).  With a mesh, more
    logical axes than ``x`` has dimensions raise ``ValueError``, as the
    JAX one's constraint does; an axis whose mesh extent does not divide
    its dimension would be left unsplit there (recurrentgemma's 10 heads
    do not split 16 ways), which here is nothing to do."""
    if get_mesh() is not None and len(logical) > x.dim():
        raise ValueError(f"{len(logical)} logical axes for a tensor of "
                         f"{x.dim()} dimensions")
    return x


def named_sharding(*logical):
    """The ``NamedSharding`` of the logical axes under the current mesh;
    None without one."""
    mesh = get_mesh()
    if mesh is None:
        return None
    from ..launch.mesh import NamedSharding
    return NamedSharding(mesh, pspec(*logical))


def dense_init(gen: torch.Generator, shape, scale: float, device,
               dtype=PARAM_DTYPE) -> torch.Tensor:
    """``scale`` times standard normal draws from ``gen``, in ``dtype``."""
    out = torch.randn(shape, generator=gen, device=device,
                      dtype=torch.float32)
    return out.mul_(scale).to(dtype)


def bf16(w: torch.Tensor) -> torch.Tensor:
    """A weight in the compute dtype, as the JAX package casts it."""
    return w.to(COMPUTE_DTYPE)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., S, H, E) or (..., S, E); positions: (..., S)."""
    E = x.shape[-1]
    freqs = rope_freqs(E, theta, x.device)                       # (E/2,)
    ang = positions[..., None].to(torch.float32) * freqs         # (..., S, E/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    extra = x.dim() - ang.dim() - 1
    for _ in range(extra):
        cos, sin = cos[..., None, :], sin[..., None, :]
    xf1 = x[..., :E // 2].to(torch.float32)
    xf2 = x[..., E // 2:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def activation_fn(kind: str):
    if kind in ("swiglu", "silu"):
        return F.silu
    if kind in ("geglu", "gelu"):
        return lambda x: F.gelu(x, approximate="tanh")
    if kind == "relu2":
        return lambda x: torch.square(torch.relu(x))
    raise ValueError(kind)


def is_gated(kind: str) -> bool:
    return kind in ("swiglu", "geglu")


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``x · rsqrt(mean x² + eps) · (1 + w)`` in fp32, in x's dtype (B7,
    ``models.autograd.RMSNormFn``, computes the same function)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.to(torch.float32))
            ).to(x.dtype)


# ---------------------------------------------------------------------------
# remat: tags and the selective-checkpoint policy
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::tag", mutates_args=())
def _tag_op(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()             # a custom op's output may not alias x


_tag_op.register_autograd(lambda ctx, grad: (grad, None))
# the op's shape on meta tensors and under fake modes (the dry run's walk)
_tag_op.register_fake(lambda x, name: torch.empty_like(x))


def tag(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` under the remat name ``name``.  Only a backward reads a name,
    so where none will run (grad mode off, or ``x`` needs no gradient) the
    tensor is returned as it is and no op is dispatched."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _tag_op(x, name)
    return x


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class RematPolicy:
    """Selective activation checkpointing that keeps the tensors tagged
    with one of ``save_names`` and recomputes everything else (``()``: the
    JAX package's ``nothing_saveable``; otherwise its
    ``save_only_these_names``).

    :meth:`checkpoint` runs one region (a layer) under
    ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` with
    this object as the policy of ``create_selective_checkpoint_contexts``.
    The backward re-runs the whole region, the kept tags' outputs taken
    from the cache, so an ``autograd.Function`` inside it (a kernel
    launch no aten op shows) runs its forward again.  ``saved_bytes``
    counts what the policy keeps: the regions' inputs that are not
    parameters, and every kept tag's output."""

    def __init__(self, save_names: Iterable[str] = ()):
        self.save_names = frozenset(save_names)
        self.saved_bytes = 0

    def __repr__(self) -> str:
        return f"RematPolicy({sorted(self.save_names)})"

    def __call__(self, ctx, op, *args, **kwargs):
        if (op is torch.ops.repro_torch.tag.default
                and args[1] in self.save_names):
            if not ctx.is_recompute:
                self.saved_bytes += _nbytes(args[0])
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    def _contexts(self):
        return create_selective_checkpoint_contexts(self)

    def checkpoint(self, fn, *args):
        """``fn(*args)`` as one checkpointed region."""
        self.saved_bytes += sum(_nbytes(a) for a in args
                                if not (isinstance(a, torch.Tensor)
                                        and a.is_leaf))
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=self._contexts)
