"""The models over a device mesh: the per-slot forward (prefill, train)
and the per-slot decode step, for all six families.

The JAX package partitions one program with GSPMD, steered by
``constrain`` and the jit's in/out shardings.  The port has no
partitioner, so this module walks the mesh's slots itself (the design of
``launch/mesh.py``'s solver mesh): the parameters come in per-slot form
(``launch.shardings.shard_tree`` of ``params_for``'s shardings), each
slot computes on its own blocks, and every exchange is an explicit
``DeviceMesh.psum`` / ``all_gather`` / ``gather`` in slot order.

* **tensor parallel on "model"**, where a block's leaves split whole
  heads, channels or experts: attention's ``wq``/``wk``/``wv`` by columns
  (each slot B5 on H/TP query and KVH/TP kv heads) and ``wo`` by rows; the
  MLP's ``w_gate``/``w_up`` by columns and ``w_down`` by rows (each slot
  B6 on F/TP hidden columns); the RG-LRU's channels (B8 on D/TP); the
  RWKV's heads (B9 on H/TP); the MoE's experts (each slot its experts'
  share of the dispatch and the combine; the router is replicated, so
  the routes are computed once a data group and every slot of it takes
  them).  A row-parallel product leaves a partial output on every slot,
  which is psummed over the model slots;
* **data parallel on "data"** (and "pod"): the batch splits over the data
  slots when they divide it (``launch.shardings.batch_sharding``), else
  every data slot computes all of it;
* norms are replicated: every slot runs B7 on its own copy of the
  residual stream; ``embed`` is vocab-parallel (each slot looks up the
  tokens in its rows, zeros elsewhere, then a psum); ``lm_head`` is
  column-parallel, its logits gathered to slot 0 as the global result.

**The sums.**  A row-parallel partial is the product's output in bf16,
the dtype the reference's products yield (``bf16 @ bf16`` in
``repro/models/transformer.py:226-237``, and its B6 returns x's dtype).
The partials are summed in fp32, in slot order, and the total rounded to
bf16 once: the unsharded product rounds its fp32 accumulator once, so the
sharded one differs from it by each partial's bf16 rounding and the order
of the sum, and by nothing else.  The embedding's psum adds one nonzero
row to zeros and is exact.  An MoE combine sums its (token, k) products in
fp32 across the slots before the sum over k, as the unsharded combine
does within one slot.

**The gather fallback.**  Where the JAX resolution splits a leaf but not
along whole heads or channels, each slot all-gathers the block's leaves
and computes it replicated (no psum).  Among the registered archs at TP
2 to 16 this is attention alone: in recurrentgemma-2b at every TP > 1
(10 query heads of 256 and 1 kv head: its 2560 query columns split 4
ways, its heads do not, and its single kv head never does) and, at TP
16, in the archs of 8 kv heads (granite-3-8b, granite-moe-1b-a400m,
h2o-danube-1.8b, llama-3.2-vision-11b, minitron-8b); the reduced
configs' 2 kv heads take it at TP 4.  An RWKV layer whose heads, or an
MLP, RG-LRU or MoE whose width, TP does not divide would take it too.
Such an attention layer's KV cache is sequence-sharded (``cache_pspecs``'
fallback) or replicated: a decode step gathers it, writes the new entry
and copies each slot's block back into it.

**MoE groups.**  Each data slot routes its own tokens as one group, the
JAX package's grouping under a mesh whose data axes split the batch
(``repro/models/moe.py:_n_groups``); where the batch does not split, the
group is the whole batch.

Kernels launch through the same wrappers and autograd Functions as the
unsharded model (``models.autograd``), so training differentiates through
the per-slot launches and the exchanges with no new backward, and on a
CUDA device nothing falls back to a plain version.  Launches are K times
the unsharded model's for the replicated norms, and one a slot for every
split block.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..core.policy import CelloPlan
from ..launch.shardings import Sharded, local_tree, map_tree, tree_leaves
from . import moe as _moe
from .common import COMPUTE_DTYPE, bf16, is_gated, tag
from .recurrent import (apply_rglru_seq, apply_rglru_step, apply_rwkv_seq,
                        apply_rwkv_step)
from .transformer import (_attend, _check_family, _decode_attend, _mlp,
                          _norm, _position, residual_layer)

Parts = List[torch.Tensor]


def _is_sharded(x) -> bool:
    return isinstance(x, Sharded)


def _splits(leaf: Sharded, dim: int) -> bool:
    """Whether ``leaf`` is split over "model" along ``dim``."""
    spec = leaf.sharding.spec
    if dim >= len(spec) or spec[dim] is None:
        return False
    ax = spec[dim]
    return "model" in ((ax,) if isinstance(ax, str) else ax)


class _Walk:
    """One pass over the slots of ``mesh`` with the per-slot ``params``."""

    def __init__(self, params, cfg: ArchConfig, plan: CelloPlan):
        _check_family(cfg)
        leaves = tree_leaves(params, _is_sharded)
        if not leaves or not isinstance(leaves[0], Sharded):
            raise TypeError("the parameters are not in per-slot form: "
                            "shard them with launch.shardings.shard_tree")
        self.mesh = mesh = leaves[0].mesh
        self.params, self.cfg, self.plan = params, cfg, plan
        self.K = mesh.size
        self.tp = mesh.shape.get("model", 1)
        data_axes = mesh.data_axes or None
        self.dp = mesh.axis_size(data_axes)
        self.slot_g = [mesh.index(k, data_axes) for k in range(self.K)]
        self.slot_m = [mesh.index(k, "model" if self.tp > 1 else None)
                       for k in range(self.K)]
        # the data groups' slots, each in model order
        self.groups = mesh.groups(("model",))
        self.devs = mesh.devices

    # -- helpers ------------------------------------------------------------

    def whole(self, tree) -> List[Any]:
        """Per slot, ``tree`` with every leaf split over "model"
        all-gathered (the fallback)."""
        def gathered(leaf: Sharded) -> Tuple[torch.Tensor, ...]:
            dims = [i for i in range(len(leaf.shape)) if _splits(leaf, i)]
            return tuple(self.mesh.all_gather(leaf.parts, ("model",), dims[0])
                         if dims else leaf.parts)
        per = map_tree(gathered, tree, is_leaf=_is_sharded)
        return [map_tree(lambda t, k=k: t[k], per) for k in range(self.K)]

    def psum(self, parts: Parts, dtype) -> Parts:
        """The model slots' partials summed in fp32, then ``dtype``."""
        return [t.to(dtype) for t in self.mesh.psum(parts, ("model",),
                                                     dtype=torch.float32)]

    def batch_split(self, B: int) -> bool:
        return self.dp > 1 and B % self.dp == 0

    def per_slot(self, t: Optional[torch.Tensor], split: bool) -> List:
        """A global batch-major tensor's block on every slot."""
        if t is None:
            return [None] * self.K
        b = t.shape[0] // self.dp if split else t.shape[0]
        return [(t[self.slot_g[k] * b:(self.slot_g[k] + 1) * b] if split
                 else t).to(self.devs[k]) for k in range(self.K)]

    def to_global(self, parts: Parts, model_dim: Optional[int],
                  split: bool) -> torch.Tensor:
        """The slots' blocks as one global tensor on slot 0: the model
        slots' along ``model_dim`` (None: they hold replicas), the data
        groups' along dim 0 (only group 0's where the batch is not
        split)."""
        rows = []
        for members in (self.groups if split else self.groups[:1]):
            slots = members if model_dim is not None else members[:1]
            rows.append(self.mesh.gather(parts, slots,
                                         model_dim if model_dim is not None
                                         else 0))
        return rows[0] if len(rows) == 1 else torch.cat(rows, 0)

    # -- embedding and logits -------------------------------------------------

    def embed(self, tokens_k: List[torch.Tensor]) -> Parts:
        emb = self.params["embed"]
        if _splits(emb, 0):
            rows_l = emb.shape[0] // self.tp
            parts = []
            for k in range(self.K):
                local = tokens_k[k] - self.slot_m[k] * rows_l
                inside = (local >= 0) & (local < rows_l)
                rows = emb.parts[k][local.clamp(0, rows_l - 1)]
                parts.append(torch.where(inside[..., None], rows,
                                         torch.zeros_like(rows)))
            rows = self.mesh.psum(parts, ("model",))
        else:
            rows = [emb.parts[k][tokens_k[k]] for k in range(self.K)]
        # a host scalar, as models.embed_tokens multiplies (no copy to
        # the device, so the step can be captured)
        scale = torch.tensor(math.sqrt(self.cfg.d_model), dtype=COMPUTE_DTYPE)
        return [r.to(COMPUTE_DTYPE) * scale for r in rows]

    def logits(self, xs: Parts, split: bool, gather: bool = True):
        """The logits on slot 0 (``gather``), or each slot's block of them
        (its batch rows, its vocab columns where ``lm_head`` splits)."""
        fn = self.params["final_norm"]
        lm = self.params["lm_head"]
        out = []
        for k in range(self.K):
            h = _norm(xs[k], fn.parts[k], self.cfg, self.plan)
            out.append((h.to(COMPUTE_DTYPE) @ bf16(lm.parts[k])
                        ).to(torch.float32))
        if not gather:
            return out
        return self.to_global(out, -1 if _splits(lm, 1) else None, split)

    # -- blocks ---------------------------------------------------------------

    def _attn_split(self, a: Dict[str, Sharded]) -> bool:
        cfg = self.cfg
        return (cfg.n_heads % self.tp == 0 and cfg.n_kv_heads % self.tp == 0
                and all(_splits(a[n], 1) for n in ("wq", "wk", "wv"))
                and _splits(a["wo"], 0))

    def _local_cfg(self) -> ArchConfig:
        cfg = self.cfg
        return dataclasses.replace(
            cfg, n_heads=cfg.n_heads // self.tp,
            n_kv_heads=cfg.n_kv_heads // self.tp,
            head_dim=cfg.resolved_head_dim)

    def _views(self, tree, split: bool) -> List[Any]:
        return ([local_tree(tree, k) for k in range(self.K)] if split
                else self.whole(tree))

    def attend(self, a, hs: Parts, kind: str, positions: Parts,
               imgs: List) -> Tuple[Parts, List, bool]:
        cfg = self.cfg
        split = self._attn_split(a)
        lcfg = self._local_cfg() if split else cfg
        views = self._views(a, split)
        ys, entries = [], []
        for k in range(self.K):
            y, kv = _attend(views[k], hs[k], cfg=lcfg, plan=self.plan,
                            causal=(not cfg.encoder_only) and kind == "attn",
                            img=imgs[k] if kind == "xattn" else None,
                            rope=not cfg.encoder_only,
                            positions=positions[k])
            ys.append(y)
            entries.append(kv)
        if split:
            ys = self.psum(ys, hs[0].dtype)
        return ys, entries, split

    def _rec_split(self, p: Dict[str, Sharded], kind: str) -> bool:
        if kind == "rglru":
            return all(_splits(p[n], 1) for n in ("w_x", "w_gate_r",
                                                   "w_gate_i")) and \
                _splits(p["w_out"], 0) and _splits(p["a_param"], 0)
        return (self.cfg.n_heads % self.tp == 0
                and all(_splits(p[n], 1) for n in ("w_r", "w_k", "w_v",
                                                    "w_w"))
                and all(_splits(p[n], 0) for n in ("w_o", "u", "w_bias")))

    def recurrent(self, p, hs: Parts, kind: str) -> Tuple[Parts, List, bool]:
        split = self._rec_split(p, kind)
        views = self._views(p, split)
        heads = self.cfg.n_heads // (self.tp if split else 1)
        ys, entries = [], []
        for k in range(self.K):
            if kind == "rglru":
                y, e = apply_rglru_seq(views[k], hs[k])
            else:
                y, e = apply_rwkv_seq(views[k], hs[k], heads)
            ys.append(y)
            entries.append(e)
        if split:
            ys = self.psum(ys, hs[0].dtype)
        return ys, entries, split

    def mlp(self, layer, hs: Parts, split_batch: bool) -> Parts:
        cfg = self.cfg
        if cfg.is_moe:
            return self.moe(layer["moe"], hs)
        m = layer["mlp"]
        names = ("w_gate", "w_up") if is_gated(cfg.activation) else ("w_up",)
        split = all(_splits(m[n], 1) for n in names) and \
            _splits(m["w_down"], 0)
        views = self._views(m, split)
        outs = [_mlp({"mlp": views[k]}, hs[k], cfg, self.plan)
                for k in range(self.K)]
        return self.psum(outs, hs[0].dtype) if split else outs

    def moe(self, p, hs: Parts) -> Parts:
        """Experts over the model slots: the routes once a data group
        (the router is replicated), each slot its experts' share of the
        dispatch and the combine, the (token, k) products psummed in fp32
        and summed over k, as ``models.moe.apply_moe`` does in one."""
        cfg = self.cfg
        split = all(_splits(p[n], 0) for n in p if n != "w_router")
        views = self._views(p, split)
        E = cfg.n_experts
        e_l = E // self.tp if split else E
        prods: Parts = [None] * self.K
        for members in self.groups:
            x = hs[members[0]]
            B, S, D = x.shape
            flat = x.reshape(B * S, D)
            r = _moe.route(views[members[0]]["w_router"], flat,
                           top_k=cfg.top_k,
                           capacity_factor=self.plan.moe_capacity_factor)
            for k in members:
                first = self.slot_m[k] * e_l if split else 0
                prods[k] = _moe.expert_share(
                    views[k], hs[k].reshape(B * S, D), r,
                    activation=cfg.activation, first=first, n_local=e_l)
        if split:
            prods = self.mesh.psum(prods, ("model",), dtype=torch.float32)
        out = []
        for k in range(self.K):
            B, S, D = hs[k].shape
            y = prods[k].float().sum(dim=1).to(COMPUTE_DTYPE)
            out.append(tag(y.reshape(B, S, D).to(hs[k].dtype), "mlp_out"))
        return out

    def norm(self, xs: Parts, w: Sharded) -> Parts:
        """B7 (or the plain norm) on every slot's copy of the stream."""
        return [_norm(xs[k], w.parts[k], self.cfg, self.plan)
                for k in range(self.K)]

    def layer(self, i: int, xs: Parts, mixer, split_batch: bool,
              mid=None):
        """``transformer.residual_layer`` of layer ``i`` over the slots."""
        L = self.params["layers"][i]
        return residual_layer(
            xs, L, norm=self.norm, mixer=mixer,
            ffn=lambda hs: self.mlp(L, hs, split_batch),
            add=lambda a, b: [u + v for u, v in zip(a, b)], mid=mid)

    def block(self, i: int, kind: str, xs: Parts, positions: Parts,
              imgs: List, split_batch: bool, want_cache: bool):
        L = self.params["layers"][i]

        def mixer(hs):
            if kind in ("attn", "xattn"):
                ys, entries, split = self.attend(L["attn"], hs, kind,
                                                 positions, imgs)
                if not want_cache:
                    return ys, None
                dim = 2 if split else None
                return ys, tuple(self.to_global([e[j] for e in entries],
                                                dim, split_batch)
                                 for j in (0, 1))
            if kind in ("rglru", "rwkv"):
                ys, entries, split = self.recurrent(L[kind], hs, kind)
                return ys, (self.to_global(entries, 1 if split else None,
                                           split_batch)
                            if want_cache else None)
            raise ValueError(kind)
        return self.layer(i, xs, mixer, split_batch,
                          mid=lambda xs: [tag(x, "x_mid") for x in xs])

    # -- decode ---------------------------------------------------------------

    def decode_attend(self, a, C, hs: Parts, pos: Parts) -> Parts:
        """One query token a sequence against every slot's cache block,
        written in place; a sequence-sharded cache is gathered, updated and
        each slot's block copied back."""
        cfg = self.cfg
        split = self._attn_split(a)
        lcfg = self._local_cfg() if split else cfg
        views = self._views(a, split)
        kv = {n: C[n] for n in ("k", "v")}
        seq = not split and _splits(kv["k"], 1)
        full = ({n: self.mesh.all_gather(kv[n].parts, ("model",), 1)
                 for n in kv} if seq else
                {n: kv[n].parts for n in kv})
        ys = []
        for k in range(self.K):
            entry = {"k": full["k"][k], "v": full["v"][k],
                     "pos_idx": C["pos_idx"].parts[k]}
            y, _ = _decode_attend(views[k], entry, hs[k], pos[k],
                                  cfg=lcfg, plan=self.plan, donate=True)
            ys.append(y)
        if seq:              # each slot's block of the updated cache, back
            for n in kv:
                for k in range(self.K):
                    z = kv[n].parts[k].shape[1]
                    j = self.slot_m[k]
                    kv[n].parts[k].copy_(full[n][k][:, j * z:(j + 1) * z])
        return self.psum(ys, hs[0].dtype) if split else ys

    def decode_recurrent(self, p, state: Sharded, hs: Parts,
                         kind: str) -> Parts:
        split = self._rec_split(p, kind)
        views = self._views(p, split)
        ys = []
        for k in range(self.K):
            if kind == "rglru":
                y, _ = apply_rglru_step(views[k], hs[k], state.parts[k],
                                        donate=True)
            else:
                heads = self.cfg.n_heads // (self.tp if split else 1)
                y, _ = apply_rwkv_step(views[k], hs[k], state.parts[k],
                                       heads, donate=True)
            ys.append(y)
        return self.psum(ys, hs[0].dtype) if split else ys

    def decode_block(self, i: int, kind: str, xs: Parts, cache, pos: Parts,
                     split_batch: bool) -> Parts:
        L = self.params["layers"][i]
        C = cache["layers"][i]

        def mixer(hs):
            if kind in ("attn", "xattn"):
                return self.decode_attend(L["attn"], C, hs, pos), None
            if kind in ("rglru", "rwkv"):
                state = C["h" if kind == "rglru" else "s"]
                return self.decode_recurrent(L[kind], state, hs, kind), None
            raise ValueError(kind)
        return self.layer(i, xs, mixer, split_batch)[0]


def apply_moe(params, hs: Parts, cfg: ArchConfig,
              plan: CelloPlan) -> Parts:
    """One MoE FFN over the mesh: ``params`` an MoE layer's per-slot
    leaves, ``hs`` each slot's (B, S, D) input.  Returns each slot's
    output, its data group's tokens (the model slots' copies equal)."""
    return _Walk(params, cfg, plan).moe(params, hs)


def forward(params, cfg: ArchConfig, plan: CelloPlan, tokens: torch.Tensor,
            *, frames: Optional[torch.Tensor] = None,
            img: Optional[torch.Tensor] = None, mode: str = "prefill",
            remat_policy=None, gather_logits: bool = True):
    """``models.forward`` over the mesh of ``params`` (per-slot form).
    The inputs are global tensors; each slot takes its batch block.
    Returns (logits (B, S, padded_vocab) fp32 on slot 0, [cache entry per
    layer] gathered to slot 0 in prefill, Nones in train).  With a
    ``remat_policy`` each layer, all slots together, is one checkpointed
    region, so the recompute runs every slot's kernels again.  With
    ``gather_logits=False`` the logits are each slot's block of them (a
    list), as a sharded output keeps them."""
    if mode not in ("prefill", "train"):
        raise ValueError(f"mode {mode!r}: forward runs 'prefill' or 'train'")
    if remat_policy is not None and mode != "train":
        raise ValueError("remat_policy applies to mode='train' only")
    w = _Walk(params, cfg, plan)
    src = frames if frames is not None else tokens
    B, S = src.shape[:2]
    split = w.batch_split(B)
    if frames is not None:
        xs = [f.to(COMPUTE_DTYPE) for f in w.per_slot(frames, split)]
    else:
        xs = w.embed(w.per_slot(tokens, split))
    imgs = w.per_slot(img, split)
    positions = [torch.arange(S, device=d) for d in w.devs]
    caches = []
    want_cache = mode == "prefill"
    for i, kind in enumerate(cfg.layer_kinds()):
        def block(*xs_in, i=i, kind=kind):
            out, entry = w.block(i, kind, list(xs_in), positions, imgs,
                                 split, want_cache)
            return tuple(out), entry
        if remat_policy is not None:
            out, entry = remat_policy.checkpoint(block, *xs)
        else:
            out, entry = block(*xs)
        xs = list(out)
        caches.append(entry)
    return w.logits(xs, split, gather_logits), caches


def decode_step(params, cache, cfg: ArchConfig, plan: CelloPlan,
                tokens: torch.Tensor, pos, *, gather_logits: bool = True):
    """``models.decode_step(..., donate=True)`` over the mesh: ``params``
    and ``cache`` in per-slot form (``cache_for``'s shardings), ``tokens``
    (B, 1) global, ``pos`` a host int or a 0-d tensor.  Every slot's cache
    blocks are written in place.  Returns (logits (B, 1, padded_vocab)
    fp32 on slot 0, or each slot's block with ``gather_logits=False``,
    cache).  Nothing reads a device value on the host, so the step can be
    captured in one CUDA graph."""
    w = _Walk(params, cfg, plan)
    split = w.batch_split(tokens.shape[0])
    xs = w.embed(w.per_slot(tokens, split))
    pos_k = [_position(pos, d) for d in w.devs]
    for i, kind in enumerate(cfg.layer_kinds()):
        xs = w.decode_block(i, kind, xs, cache, pos_k, split)
    return w.logits(xs, split, gather_logits), cache


def value_and_grad(loss_fn):
    """``(params, batch) -> (loss, grads)`` for ``params`` in per-slot
    form: ``grads`` a per-slot tree like ``params``, each slot's block of
    every leaf summed over the slots that hold its replicas (the mesh axes
    its sharding does not name: the data slots, and the model slots too
    for a leaf the model slots replicate), so that every replica holds the
    gradient of the global leaf."""
    def fn(params, batch):
        leaves = tree_leaves(params, _is_sharded)
        alias = [Sharded([p.detach().requires_grad_(True) for p in s.parts],
                         s.sharding, s.shape) for s in leaves]
        it = iter(alias)
        tree = map_tree(lambda s: next(it), params,
                        is_leaf=_is_sharded)
        loss = loss_fn(tree, batch)
        flat = [p for s in alias for p in s.parts]
        grads = list(torch.autograd.grad(loss, flat, materialize_grads=True))
        del flat
        out, i = [], 0
        for s in alias:
            n = len(s.parts)
            out.append(reduce_replicas(grads[i:i + n], s))
            grads[i:i + n] = [None] * n
            i += n
        it = iter(out)
        return loss.detach(), map_tree(
            lambda s: next(it), params,
            is_leaf=_is_sharded)
    return fn


def _address(t: torch.Tensor):
    """Where ``t``'s data starts: its pointer, or on meta (every pointer
    0) its storage and offset."""
    if t.is_meta:
        return t.untyped_storage()._cdata, t.storage_offset()
    return t.data_ptr()


def reduce_replicas(parts: Parts, like: Sharded) -> Sharded:
    """``parts`` (one a slot, shaped as ``like``'s blocks) summed over the
    mesh axes that ``like``'s sharding does not name, in slot order, in
    place (``DeviceMesh.psum_``)."""
    mesh = like.mesh
    axes = tuple(a for a in mesh.axis_names
                 if a not in like.sharding.axes() and mesh.shape[a] > 1)
    if axes:
        if len({_address(p) for p in parts}) < len(parts):
            parts = [p.clone() for p in parts]     # autograd shared one
        mesh.psum_(parts, axes)
    return Sharded(parts, like.sharding, like.shape)
