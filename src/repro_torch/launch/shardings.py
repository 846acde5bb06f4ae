"""Sharding rules: logical axes → NamedShardings, plus per-cell input specs,
and the per-slot form of a tree.

The counterpart of ``repro.launch.shardings``.  Logical axes resolve
through ``models.common.resolve_axis`` with the mesh passed in (that
module keeps the one table): "model" → the "model" mesh axis (TP / EP),
"batch" / "data" → ("pod", "data") when the pod axis exists, else
("data",).  Param/optimizer/cache spec trees come from the model zoo
(``models.param_pspecs``, ``cache_pspecs``, ``optim.zero1_pspecs``); this
module binds them to a :class:`~repro_torch.launch.mesh.DeviceMesh`, with
the JAX rule that an axis whose extent does not divide its dimension is
dropped (left replicated).  The stand-ins the JAX package builds as
``ShapeDtypeStruct``s are ``meta``-device tensors here (no allocation),
each carrying its sharding as ``.sharding``.

The port's trees keep one dict a layer (``params["layers"]``,
``cache["layers"]``), which is the JAX package's *split* layout, so
``params_for_split`` and ``cache_for_split`` are ``params_for`` and
``cache_for``.

A tree in **per-slot form** (:func:`shard_tree`) has a :class:`Sharded`
leaf for each global leaf: one contiguous tensor a slot, the slot's block
of the leaf under its sharding, on the slot's device.  :func:`gather_tree`
puts the blocks back together; :func:`local_tree` is one slot's view.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..models import cache_pspecs, init_cache, init_params, param_pspecs
from ..models.common import COMPUTE_DTYPE, PARAM_DTYPE, resolve_axis
from .mesh import DeviceMesh, NamedSharding, PartitionSpec

PyTree = Any

__all__ = ["NamedSharding", "PartitionSpec", "Sharded", "batch_sharding",
           "cache_for", "cache_for_split", "gather_tree", "input_specs",
           "local_tree", "map_tree", "params_for", "params_for_split",
           "resolve_tree", "shaped", "shard_tree", "tree_leaves"]


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def map_tree(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` (dicts and lists are nodes;
    ``is_leaf`` may stop the walk earlier), with the matching subtrees of
    ``rest``."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree, is_leaf=None) -> List[Any]:
    out: List[Any] = []
    map_tree(out.append, tree, is_leaf=is_leaf)
    return out


def resolve_tree(mesh: DeviceMesh, logical_tree: PyTree,
                 shapes: Optional[PyTree] = None) -> PyTree:
    """Logical spec tree (tuples) → NamedSharding tree.

    With ``shapes`` (a matching tree of tensors, ``meta`` ones say), axes
    whose mesh extent does not divide the dimension are dropped (left
    replicated) — e.g. recurrentgemma's 10 attention heads cannot shard
    over model=16."""
    def one(t, shape=None):
        axes = [resolve_axis(a, mesh) for a in t]
        if shape is not None:
            dims = tuple(shape.shape)
            axes += [None] * (len(dims) - len(axes))
            axes = [a if a is not None and d % mesh.axis_size(a) == 0
                    else None for a, d in zip(axes, dims)]
        return NamedSharding(mesh, PartitionSpec(*axes))

    if shapes is None:
        return map_tree(one, logical_tree, is_leaf=_is_spec)
    return map_tree(one, logical_tree, shapes, is_leaf=_is_spec)


def shaped(tree_shapes: PyTree, tree_shardings: PyTree) -> PyTree:
    """Shapes tree × sharding tree → ``meta`` tensors of the global
    shapes and dtypes, each with its sharding as ``.sharding``."""
    def one(s, sh):
        t = torch.empty(tuple(s.shape), dtype=s.dtype, device="meta")
        t.sharding = sh
        return t
    return map_tree(one, tree_shapes, tree_shardings)


def batch_sharding(mesh: DeviceMesh, ndim: int, batch_dim_size: int
                   ) -> NamedSharding:
    ax = resolve_axis("batch", mesh)
    if ax is None or batch_dim_size % mesh.axis_size(ax) != 0:
        ax = None                      # batch too small to shard (e.g. B=1)
    return NamedSharding(mesh, PartitionSpec(ax, *([None] * (ndim - 1))))


def params_for(cfg: ArchConfig, mesh: DeviceMesh) -> Tuple[PyTree, PyTree]:
    """(``meta`` params tree, NamedSharding tree) — no allocation."""
    return params_for_split(cfg, mesh)


def cache_for(cfg: ArchConfig, mesh: DeviceMesh, batch: int, seq_len: int
              ) -> Tuple[PyTree, PyTree]:
    shapes = init_cache(cfg, batch, seq_len, device="meta")
    tp = mesh.shape.get("model", 1)
    shardings = resolve_tree(
        mesh, cache_pspecs(cfg, batch, seq_len=seq_len, tp=tp), shapes)
    return shaped(shapes, shardings), shardings


def params_for_split(cfg: ArchConfig, mesh: DeviceMesh, dtype=None
                     ) -> Tuple[PyTree, PyTree]:
    """``params_for`` with the weights in ``dtype`` (``PARAM_DTYPE`` when
    None): the port's tree is already one entry a layer, the JAX
    package's split layout (``repro/launch/shardings.py:159``)."""
    shapes = init_params(cfg, device="meta",
                         dtype=dtype if dtype is not None else PARAM_DTYPE)
    shardings = resolve_tree(mesh, param_pspecs(cfg), shapes)
    return shaped(shapes, shardings), shardings


def cache_for_split(cfg: ArchConfig, mesh: DeviceMesh, batch: int,
                    seq_len: int) -> Tuple[PyTree, PyTree]:
    """``cache_for``: the port's cache is already one entry a layer."""
    return cache_for(cfg, mesh, batch, seq_len)


def input_specs(cfg: ArchConfig, shape: ShapeSpec, mesh: DeviceMesh
                ) -> Dict[str, Any]:
    """``meta`` stand-ins (with ``.sharding``) for every model input of one
    cell."""
    B, S = shape.global_batch, shape.seq_len

    def stand_in(s, dtype):
        t = torch.empty(s, dtype=dtype, device="meta")
        t.sharding = batch_sharding(mesh, len(s), s[0]) if s else None
        return t

    out: Dict[str, Any] = {}
    if shape.mode in ("train", "prefill"):
        if cfg.family == "audio":
            out["frames"] = stand_in((B, S, cfg.d_model), COMPUTE_DTYPE)
        out["tokens"] = stand_in((B, S), torch.int32)
        if cfg.family == "vlm":
            out["img"] = stand_in((B, cfg.vision_seq, cfg.d_model),
                                  COMPUTE_DTYPE)
        if shape.mode == "train":
            out["labels"] = stand_in((B, S), torch.int32)
    else:                                    # decode
        out["tokens"] = stand_in((B, 1), torch.int32)
        out["pos"] = stand_in((), torch.int32)
        out["cache"], out["cache_shardings"] = cache_for_split(cfg, mesh, B,
                                                               S)
    return out


# ---------------------------------------------------------------------------
# the per-slot form
# ---------------------------------------------------------------------------

class Sharded:
    """One leaf in per-slot form: ``parts[k]`` is slot ``k``'s block of the
    global leaf under ``sharding`` (contiguous, on the slot's device)."""

    __slots__ = ("parts", "sharding", "shape", "dtype")

    def __init__(self, parts: Sequence[torch.Tensor],
                 sharding: NamedSharding, shape: Sequence[int]):
        self.parts = list(parts)
        self.sharding = sharding
        self.shape = tuple(shape)
        self.dtype = self.parts[0].dtype

    @property
    def mesh(self) -> DeviceMesh:
        return self.sharding.mesh

    def gather(self) -> torch.Tensor:
        """The global tensor, on slot 0's device: every slot's block
        written where it belongs (replicas write the same block)."""
        mesh = self.sharding.mesh
        out = torch.empty(self.shape, dtype=self.dtype,
                          device=self.parts[0].device)
        for k, part in enumerate(self.parts):
            out[self.sharding.block(k, self.shape)] = part.to(out.device)
        return out

    def nbytes(self, slot: int) -> int:
        p = self.parts[slot]
        return p.numel() * p.element_size()

    def __repr__(self) -> str:
        return (f"Sharded({tuple(self.shape)}, {self.dtype}, "
                f"{self.sharding.spec!r})")


def _is_sharded(x) -> bool:
    return isinstance(x, Sharded)


def shard_leaf(t: torch.Tensor, sharding: NamedSharding) -> Sharded:
    mesh = sharding.mesh
    parts = [t[sharding.block(k, t.shape)].to(mesh.devices[k], copy=True)
             .contiguous() for k in range(mesh.size)]
    return Sharded(parts, sharding, t.shape)


def shard_tree(tree: PyTree, shardings: PyTree) -> PyTree:
    """A global tree in per-slot form: every leaf's block copied to each
    slot (a new tensor a slot; the global tree is left as it was)."""
    return map_tree(shard_leaf, tree, shardings)


def gather_tree(tree: PyTree) -> PyTree:
    """A per-slot tree's global form (new tensors, on slot 0's device)."""
    return map_tree(lambda s: s.gather(), tree, is_leaf=_is_sharded)


def local_tree(tree: PyTree, slot: int) -> PyTree:
    """Slot ``slot``'s view of a per-slot tree: its blocks, in place."""
    return map_tree(lambda s: s.parts[slot], tree, is_leaf=_is_sharded)


def slot_bytes(tree: PyTree, slot: int) -> int:
    """The bytes a per-slot tree holds on slot ``slot``."""
    return sum(s.nbytes(slot) for s in tree_leaves(tree, _is_sharded))
