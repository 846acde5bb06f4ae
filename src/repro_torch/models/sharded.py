"""The models over a device mesh: the per-slot forward (prefill, train)
and the per-slot decode step, for all six families.

The JAX package partitions one program with GSPMD, steered by
``constrain`` and the jit's in/out shardings.  The port has no
partitioner, so this module walks the mesh's slots itself (the design of
``launch/mesh.py``'s solver mesh): the parameters come in per-slot form
(``launch.shardings.shard_tree`` of ``params_for``'s shardings), each
slot computes on its own blocks, and every exchange is an explicit
``DeviceMesh.psum`` / ``pmax`` / ``all_gather`` / ``gather`` in slot
order.

* **tensor parallel on "model"**, where a block's leaves split whole
  heads, channels or experts: the MLP's ``w_gate``/``w_up`` by columns
  and ``w_down`` by rows (each slot B6 on F/TP hidden columns); the
  RG-LRU's channels (B8 on D/TP); the RWKV's heads (B9 on H/TP); the
  MoE's experts (each slot its experts' share of the dispatch and the
  combine; the router is replicated, so the routes are computed once a
  data group and every slot of it takes them).  A row-parallel product
  leaves a partial output on every slot, which is psummed over the model
  slots.  Attention takes one of three forms below;
* **data parallel on "data"** (and "pod"): the batch splits over the data
  slots when they divide it (``launch.shardings.batch_sharding``), else
  every data slot computes all of it;
* norms are replicated: every slot runs B7 on its own copy of the
  residual stream; ``embed`` is vocab-parallel (each slot looks up the
  tokens in its rows, zeros elsewhere, then a psum); ``lm_head`` is
  column-parallel: serving gathers the logits to slot 0 as the global
  result, training keeps each slot's block (``forward(...,
  gather_logits=False)``) for the vocab-parallel loss of
  ``launch.train.make_mesh_loss_fn``.

**Attention's three forms** (:meth:`_Walk.attn_form`), the reference's
``constrain(q, "batch", None, "model", None)`` and ``constrain(k / v,
..., "model", ...)``, each dropped where TP does not divide the heads
(``repro/models/transformer.py:186-188``, ``repro/models/common.py:67``):

* **split**, where TP divides the kv heads (so the query heads too):
  ``wq``/``wk``/``wv`` by columns and ``wo`` by rows, each slot B5 on
  H/TP query and KVH/TP kv heads, then the psum;
* **query-split**, where TP divides the query heads and KVH divides TP:
  each slot computes ``q`` for its H/TP heads from its ``wq`` columns and
  k / v from its ``wk`` / ``wv`` columns (KVH·E/TP of them, a part of
  one kv head), all-gathered over each run of TP/KVH model slots that
  together hold one kv head (the reference's compiled HLO gathers k and
  v in those replica groups, and moves activations, not weights); then
  B5 on its H/TP query heads against that one kv head, which is the one
  they read under GQA (head h reads h // (H/KVH)), and ``wo`` by rows
  with the psum.  The same in train mode (the all-gather is
  differentiable) and in ``xattn`` (k and v from the image rows);
* **gather** (the fallback), where TP does not divide the query heads
  (recurrentgemma-2b's 10 at TP 4 and 16, the reduced configs' 4 at TP
  8 and 16; the reference leaves q unconstrained there): each slot
  all-gathers the block's leaves and computes it whole, with no psum.
  An RWKV layer whose heads, or an MLP, RG-LRU or MoE whose width, TP
  does not divide would take it too.

**Decode** keeps the cache as ``cache_pspecs`` lays it out.  Split
attention's cache is head-sharded and each slot attends its own heads.
Where the kv heads do not split, the cache is sequence-sharded (its
length Z divides TP) or else replicated.  A sequence-sharded cache is
never gathered: each slot all-gathers the H query heads (query-split;
the gather form has them whole) and the new k / v entry, only the slot
whose block holds the ring position ``pos % Z`` writes the entry (the
others write back what they hold), each slot takes its block's scores
with the window and ring masks of ``repro/models/attention.py:126-150``,
and the slots combine as the reference's HLO does: the scores' max over
the model slots (``DeviceMesh.pmax``), the sum of their exponentials
(psum), then the normalized probabilities, rounded to bf16 as the
unsharded step rounds them, against the slot's block of v, psummed in
fp32.  A replicated cache takes the whole new entry on every slot, and a
query-split slot attends its H/TP heads against the kv head they read.

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
from .common import COMPUTE_DTYPE, apply_rope, bf16, is_gated, tag
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
                  split: bool, step: int = 1) -> torch.Tensor:
        """The slots' blocks as one global tensor on slot 0: the model
        slots' along ``model_dim`` (every ``step``-th of them, where runs
        of ``step`` hold one block; None: they hold replicas), the data
        groups' along dim 0 (only group 0's where the batch is not
        split)."""
        rows = []
        for members in (self.groups if split else self.groups[:1]):
            slots = members[::step] if model_dim is not None else members[:1]
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

    def attn_form(self, a: Dict[str, Sharded]) -> str:
        """How the model slots split the attention layer ``a``: "split",
        "query" (query-split) or "gather" (the module docstring)."""
        cfg, tp = self.cfg, self.tp
        if (cfg.n_heads % tp == 0
                and all(_splits(a[n], 1) for n in ("wq", "wk", "wv"))
                and _splits(a["wo"], 0)):
            if cfg.n_kv_heads % tp == 0:
                return "split"
            if tp % cfg.n_kv_heads == 0:
                return "query"
        return "gather"

    def _local_cfg(self, form: str) -> ArchConfig:
        """The heads one slot attends with in ``form``."""
        cfg = self.cfg
        if form == "gather":
            return cfg
        return dataclasses.replace(
            cfg, n_heads=cfg.n_heads // self.tp,
            n_kv_heads=cfg.n_kv_heads // self.tp if form == "split" else 1,
            head_dim=cfg.resolved_head_dim)

    def _views(self, tree, split: bool) -> List[Any]:
        return ([local_tree(tree, k) for k in range(self.K)] if split
                else self.whole(tree))

    def kv_span(self) -> int:
        """The model slots whose ``wk`` / ``wv`` columns make up one kv
        head (query-split form)."""
        return self.tp // self.cfg.n_kv_heads

    def kv_columns(self, views, srcs: Parts, span: int
                   ) -> Tuple[Parts, Parts]:
        """Each slot's ``wk`` and ``wv`` columns on its ``srcs`` rows,
        all-gathered over runs of ``span`` model slots: (k, v) per slot,
        (B, T, heads, E) with the heads those runs hold."""
        E = self.cfg.resolved_head_dim
        out = []
        for name in ("wk", "wv"):
            cols = [srcs[k].to(COMPUTE_DTYPE) @ bf16(views[k][name])
                    for k in range(self.K)]
            whole = self.mesh.all_gather(cols, ("model",), -1, span)
            out.append([t.reshape(*t.shape[:-1], -1, E) for t in whole])
        return out[0], out[1]

    def attend(self, a, hs: Parts, kind: str, positions: Parts,
               imgs: List) -> Tuple[Parts, List, str]:
        cfg = self.cfg
        form = self.attn_form(a)
        lcfg = self._local_cfg(form)
        views = self._views(a, form != "gather")
        kvs: List = [None] * self.K
        if form == "query":
            ks, vs = self.kv_columns(
                views, imgs if kind == "xattn" else hs, self.kv_span())
            kvs = list(zip(ks, vs))
        ys, entries = [], []
        for k in range(self.K):
            y, kv = _attend(views[k], hs[k], cfg=lcfg, plan=self.plan,
                            causal=(not cfg.encoder_only) and kind == "attn",
                            img=imgs[k] if kind == "xattn" else None,
                            rope=not cfg.encoder_only,
                            positions=positions[k], kv=kvs[k])
            ys.append(y)
            entries.append(kv)
        if form != "gather":
            ys = self.psum(ys, hs[0].dtype)
        return ys, entries, form

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
                ys, entries, form = self.attend(L["attn"], hs, kind,
                                                positions, imgs)
                if not want_cache:
                    return ys, None
                dim = None if form == "gather" else 2
                step = self.kv_span() if form == "query" else 1
                return ys, tuple(self.to_global([e[j] for e in entries],
                                                dim, split_batch, step)
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
        written in place (the module docstring's decode)."""
        form = self.attn_form(a)
        views = self._views(a, form != "gather")
        if form != "split":
            return self._decode_heads(views, form, C, hs, pos)
        lcfg = self._local_cfg(form)
        ys = []
        for k in range(self.K):
            entry = {n: C[n].parts[k] for n in ("k", "v", "pos_idx")}
            y, _ = _decode_attend(views[k], entry, hs[k], pos[k],
                                  cfg=lcfg, plan=self.plan, donate=True)
            ys.append(y)
        return self.psum(ys, hs[0].dtype)

    def _decode_heads(self, views, form: str, C, hs: Parts,
                      pos: Parts) -> Parts:
        """``transformer._decode_attend`` for a cache whose kv heads do
        not split, sequence-sharded or replicated, in the query-split or
        gather form."""
        cfg, mesh = self.cfg, self.mesh
        seq = _splits(C["k"], 1)
        H, KVH, E = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        query = form == "query"
        qs = [h.to(COMPUTE_DTYPE) @ bf16(views[k]["wq"])
              for k, h in enumerate(hs)]
        if query and seq:            # every query head, for the block
            qs = mesh.all_gather(qs, ("model",), -1)
        # the new entry's every kv head, for the slot that writes it
        k_new, v_new = self.kv_columns(views, hs,
                                       self.tp if query else 1)
        heads = qs[0].shape[-1] // E
        scores, blocks = [], []
        for k in range(self.K):
            B, p = hs[k].shape[0], pos[k]
            q = apply_rope(qs[k].reshape(B, 1, heads, E), p[None],
                           cfg.rope_theta)
            kn = apply_rope(k_new[k], p[None], cfg.rope_theta)
            kc, vc, pi = (C[n].parts[k] for n in ("k", "v", "pos_idx"))
            Zl = kc.shape[1]
            ring = (p % pi.shape[0]).long()[None]   # index_copy takes int64
            pi.index_copy_(0, ring, p[None])
            if seq:
                # only the block that holds the ring position takes the
                # entry; the others write back what they hold there
                j = self.slot_m[k]
                at = ring - j * Zl
                mine = (at >= 0) & (at < Zl)
                at = at.clamp(0, Zl - 1)
                for c, new in ((kc, kn), (vc, v_new[k])):
                    c.index_copy_(1, at, torch.where(
                        mine, new.to(c.dtype), c.index_select(1, at)))
                pi = pi[j * Zl:(j + 1) * Zl]
            else:
                kc.index_copy_(1, ring, kn.to(kc.dtype))
                vc.index_copy_(1, ring, v_new[k].to(vc.dtype))
            if heads < H:            # a query-split slot's heads read one
                h0 = self.slot_m[k] // self.kv_span()
                kc, vc = kc[:, :, h0:h0 + 1], vc[:, :, h0:h0 + 1]
            valid = (pi >= 0) & (pi <= p)
            if cfg.window:
                valid &= pi > p - cfg.window
            kvh = kc.shape[2]
            qg = (q * torch.tensor(E ** -0.5, dtype=q.dtype)).reshape(
                B, kvh, heads // kvh, E)
            s = torch.einsum("bkge,btke->bkgt", qg.float(), kc.float())
            scores.append(torch.where(valid[None, None, None, :], s,
                                      torch.full_like(s, -1e30)))
            blocks.append(vc)
        if seq:                      # the softmax over the model slots
            top = mesh.pmax([s.amax(-1, keepdim=True) for s in scores],
                            ("model",))
            ex = [torch.exp(s - m) for s, m in zip(scores, top)]
            tot = mesh.psum([e.sum(-1, keepdim=True) for e in ex],
                            ("model",))
            prs = [e / t for e, t in zip(ex, tot)]
        else:
            prs = [torch.softmax(s, dim=-1) for s in scores]
        ctx = [torch.einsum("bkgt,btke->bkge", pr.to(vc.dtype).float(),
                            vc.float()) for pr, vc in zip(prs, blocks)]
        if seq:
            ctx = mesh.psum(ctx, ("model",))
        ys = []
        for k in range(self.K):
            B = hs[k].shape[0]
            c = ctx[k].reshape(B, 1, heads * E)
            if query and seq:        # the slot's own heads, for wo's rows
                w = H // self.tp * E
                c = c[..., self.slot_m[k] * w:(self.slot_m[k] + 1) * w]
            ys.append((c.to(COMPUTE_DTYPE) @ bf16(views[k]["wo"])
                       ).to(hs[k].dtype))
        return self.psum(ys, hs[0].dtype) if query else ys

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
