"""Per-architecture layer DAG builders and execution planning, copied.

The two halves of ``repro.core.lowering``:

* the LLM layer graphs (``attention_block`` … ``layer_graph``,
  ``decode_graph``): the analysis-level view of one transformer block (or
  one decode step) that the co-designer searches, at tensor granularity.
  ``core.policy.lower_codesign`` turns the fusion groups found on them
  into the kernel flags of a ``CelloPlan``;
* execution planning for frontend (HPC) plans: fusion group -> kernel
  shape selection (``select_group_kernels``), the flat dispatch units, the
  cross-pass residency planner (``fuse_units``) and rolled-loop detection
  (``detect_rolled_loop``), joined by ``plan_execution``; and mesh
  partitioning (``partition_plan``): a plan split into K contiguous row
  blocks, one per device slot of a solver mesh (``launch.mesh``).

Both are pure Python and equal to the JAX package's field for field, so
the two packages lower the same co-designed schedule to the same plan.

The names keep the TPU vocabulary of the original (VMEM residency,
``pallas-stream`` in ``GroupKernel.describe``): they describe the
co-designer's buffer model, which the port keeps unchanged.  How the CUDA
backend maps a unit onto the card is in ``repro_torch.exec.cuda``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from ..configs.base import ArchConfig
from .graph import GraphBuilder, OpGraph, TensorKind

BF16 = 2
F32 = 4


def attention_block(b: GraphBuilder, cfg: ArchConfig, prefix: str, x: str,
                    batch: int, q_len: int, kv_len: int,
                    cross_kv: Optional[str] = None,
                    out_kind: TensorKind = TensorKind.INTERMEDIATE) -> str:
    """Standard (GQA / sliding-window / cross) attention sub-DAG. Returns the
    name of the block output tensor (pre-residual)."""
    d, h, kvh, e = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    bb, s = batch, q_len
    z = kv_len if cfg.window is None else min(kv_len, cfg.window)

    wq = b.weight(f"{prefix}.wq", (d, h * e))
    wo = b.weight(f"{prefix}.wo", (h * e, d))
    q = b.contract(f"{prefix}.q", [x, wq], f"{prefix}.q_out",
                   (bb, s, h, e), 2 * bb * s * d * h * e)

    if cross_kv is None:
        wk = b.weight(f"{prefix}.wk", (d, kvh * e))
        wv = b.weight(f"{prefix}.wv", (d, kvh * e))
        k_t = b.contract(f"{prefix}.k", [x, wk], f"{prefix}.k_out",
                         (bb, z, kvh, e), 2 * bb * z * d * kvh * e)
        v_t = b.contract(f"{prefix}.v", [x, wv], f"{prefix}.v_out",
                         (bb, z, kvh, e), 2 * bb * z * d * kvh * e)
    else:
        # cross-attention: K/V come from the (pinned-candidate) image tensor
        k_t = v_t = cross_kv

    # scores + softmax + PV: FLOPs carry full h heads (GQA broadcast free)
    scores = b.contract(f"{prefix}.scores", [q, k_t], f"{prefix}.scores_out",
                        (bb, h, s, z), 2 * bb * h * s * z * e)
    probs = b.elementwise(f"{prefix}.softmax", [scores], f"{prefix}.probs",
                          flops_per_elem=5)
    pv = b.contract(f"{prefix}.pv", [probs, v_t], f"{prefix}.pv_out",
                    (bb, s, h, e), 2 * bb * h * s * z * e)
    return b.contract(f"{prefix}.o", [pv, wo], f"{prefix}.attn_out",
                      (bb, s, d), 2 * bb * s * h * e * d, out_kind=out_kind)


def mlp_block(b: GraphBuilder, cfg: ArchConfig, prefix: str, x: str,
              tokens: int, out_kind: TensorKind = TensorKind.INTERMEDIATE) -> str:
    d, f = cfg.d_model, cfg.d_ff
    gated = cfg.activation in ("swiglu", "geglu")
    if cfg.is_moe:
        return moe_block(b, cfg, prefix, x, tokens, out_kind)
    w_up = b.weight(f"{prefix}.w_up", (d, (2 if gated else 1) * f))
    w_down = b.weight(f"{prefix}.w_down", (f, d))
    h = b.contract(f"{prefix}.up", [x, w_up], f"{prefix}.h",
                   (tokens, (2 if gated else 1) * f),
                   2 * tokens * d * (2 if gated else 1) * f)
    a = b.elementwise(f"{prefix}.act", [h], f"{prefix}.a",
                      flops_per_elem=4, out_shape=(tokens, f))
    return b.contract(f"{prefix}.down", [a, w_down], f"{prefix}.mlp_out",
                      (tokens, d), 2 * tokens * f * d, out_kind=out_kind)


def moe_block(b: GraphBuilder, cfg: ArchConfig, prefix: str, x: str,
              tokens: int, out_kind: TensorKind = TensorKind.INTERMEDIATE) -> str:
    """Top-k MoE FFN.  Routing/dispatch are data-dependent ⇒ irregular:
    their reuse must live in the implicit region (the CELLO showcase)."""
    d, f, E, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k
    gated = cfg.activation in ("swiglu", "geglu")
    w_router = b.weight(f"{prefix}.w_router", (d, E))
    w_up_e = b.weight(f"{prefix}.w_up_e", (E, d, (2 if gated else 1) * f))
    w_down_e = b.weight(f"{prefix}.w_down_e", (E, f, d))
    logits = b.contract(f"{prefix}.router", [x, w_router],
                        f"{prefix}.logits", (tokens, E), 2 * tokens * d * E,
                        dtype_bytes=F32)
    gates = b.elementwise(f"{prefix}.topk", [logits], f"{prefix}.gates",
                          flops_per_elem=2, out_shape=(tokens, k),
                          dtype_bytes=F32, irregular=True)
    # dispatch: gather tokens to experts (data-dependent addressing)
    xe = b.elementwise(f"{prefix}.dispatch", [x, gates], f"{prefix}.xe",
                       flops_per_elem=0, out_shape=(tokens * k, d),
                       irregular=True, spec="gather")
    h = b.contract(f"{prefix}.up", [xe, w_up_e], f"{prefix}.h",
                   (tokens * k, (2 if gated else 1) * f),
                   2 * tokens * k * d * (2 if gated else 1) * f)
    a = b.elementwise(f"{prefix}.act", [h], f"{prefix}.a",
                      flops_per_elem=4, out_shape=(tokens * k, f))
    ye = b.contract(f"{prefix}.down", [a, w_down_e], f"{prefix}.ye",
                    (tokens * k, d), 2 * tokens * k * f * d)
    # combine: weighted scatter-add back to token order (data-dependent)
    return b.elementwise(f"{prefix}.combine", [ye, gates],
                         f"{prefix}.mlp_out", flops_per_elem=2 * k,
                         out_shape=(tokens, d), irregular=True, spec="gather",
                         out_kind=out_kind)


def rglru_block(b: GraphBuilder, cfg: ArchConfig, prefix: str, x: str,
                batch: int, seq: int) -> str:
    """RG-LRU recurrent block (recurrentgemma): gated linear recurrence."""
    d = cfg.d_model
    bb, s = batch, seq
    wx, wgate, wa, wout = b.weights(prefix, ("wx", "wgate", "wa", "wout"),
                                    (d, d))
    xb = b.contract(f"{prefix}.proj", [x, wx], f"{prefix}.xb",
                    (bb, s, d), 2 * bb * s * d * d)
    g = b.contract(f"{prefix}.gates", [x, wgate, wa], f"{prefix}.g",
                   (bb, s, 2 * d), 2 * bb * s * d * 2 * d)
    # the recurrence itself: sequential along s => 'scan' op
    h = b.scan(f"{prefix}.scan", [xb, g], f"{prefix}.h",
               (bb, s, d), flops_per_elem=8)
    return b.contract(f"{prefix}.out", [h, wout], f"{prefix}.rglru_out",
                      (bb, s, d), 2 * bb * s * d * d)


def rwkv_block(b: GraphBuilder, cfg: ArchConfig, prefix: str, x: str,
               batch: int, seq: int) -> str:
    """RWKV6 time-mix: r/k/v/g projections + WKV6 recurrence + output."""
    d = cfg.d_model
    bb, s = batch, seq
    H, e = cfg.n_heads, cfg.resolved_head_dim
    wr, wk, wv, wg, wo, ww = b.weights(
        prefix, ("wr", "wk", "wv", "wg", "wo", "ww"), (d, d))
    rkvg = b.contract(f"{prefix}.rkvg", [x, wr, wk, wv, wg, ww],
                      f"{prefix}.rkvg_out", (bb, s, 5 * d),
                      2 * bb * s * d * 5 * d)
    # WKV6 recurrence: per head, state (e x e) updated per step
    wkv = b.scan(f"{prefix}.wkv", [rkvg], f"{prefix}.wkv_out",
                 (bb, s, d), flops=2 * bb * s * H * e * e * 4)
    return b.contract(f"{prefix}.out", [wkv, wo], f"{prefix}.rwkv_out",
                      (bb, s, d), 2 * bb * s * d * d)


def layer_graph(cfg: ArchConfig, batch: int, seq: int, *,
                layer_kind: Optional[str] = None,
                include_residuals: bool = True) -> OpGraph:
    """One transformer block as an OpGraph (the CELLO unit of analysis).

    The residual stream exhibits the paper's "complex reuse": ``x`` feeds the
    norm AND the residual add (two consumers, different distances); the block
    output feeds the next norm and the next residual add likewise.
    """
    kind = layer_kind or cfg.layer_kinds()[0]
    d = cfg.d_model
    tokens = batch * seq
    with OpGraph.build(f"{cfg.name}:{kind}:b{batch}s{seq}") as b:
        x = b.input("x", (batch, seq, d))
        ln1_w = b.weight("ln1.w", (d,))
        ln2_w = b.weight("ln2.w", (d,))
        x_n1 = b.elementwise("ln1", [x, ln1_w], "x_n1", flops_per_elem=6)

        if kind == "attn":
            y = attention_block(b, cfg, "attn", x_n1, batch, seq, seq)
        elif kind == "xattn":
            img_kv = b.input("img_kv", (batch, cfg.vision_seq,
                                        2 * cfg.n_kv_heads *
                                        cfg.resolved_head_dim))
            y = attention_block(b, cfg, "xattn", x_n1, batch, seq,
                                cfg.vision_seq, cross_kv=img_kv)
        elif kind == "rglru":
            y = rglru_block(b, cfg, "rglru", x_n1, batch, seq)
        elif kind == "rwkv":
            y = rwkv_block(b, cfg, "rwkv", x_n1, batch, seq)
        else:
            raise ValueError(kind)

        if include_residuals:
            src = b.elementwise("res1", [x, y], "x_mid", flops_per_elem=1)
        else:
            src = y
        x_n2 = b.elementwise("ln2", [src, ln2_w], "x_n2", flops_per_elem=6)
        m = mlp_block(b, cfg, "mlp", x_n2, tokens)
        if include_residuals:
            b.elementwise("res2", [src, m], "x_out", flops_per_elem=1,
                          out_kind=TensorKind.OUTPUT,
                          out_shape=(batch, seq, d))
    return b.graph


def decode_graph(cfg: ArchConfig, batch: int, kv_len: int) -> OpGraph:
    """Single-token decode step for one layer: KV-cache reuse pattern.

    The cache is an INPUT consumed by scores/PV and extended (OUTPUT) — the
    canonical multi-distance reuse tensor for serving.
    """
    kind = next((k for k in cfg.layer_kinds() if k in ("attn", "rwkv")),
                cfg.layer_kinds()[0])
    d, h, kvh, e = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    bb = batch
    z = kv_len if cfg.window is None else min(kv_len, cfg.window)
    with OpGraph.build(f"{cfg.name}:decode:b{batch}kv{kv_len}") as b:
        x = b.input("x", (bb, 1, d))
        ln1_w = b.weight("ln1.w", (d,))
        x_n1 = b.elementwise("ln1", [x, ln1_w], "x_n1", flops_per_elem=6)
        if kind == "rwkv":
            state = b.input("state", (bb, cfg.n_heads, e, e), dtype_bytes=F32)
            wr, wk, wv, wo = b.weights("t", ("wr", "wk", "wv", "wo"), (d, d))
            rkv = b.contract("t.rkv", [x_n1, wr, wk, wv], "t.rkv_out",
                             (bb, 1, 3 * d), 2 * bb * d * 3 * d)
            ty = b.scan("t.wkv", [rkv, state], "t.y", (bb, 1, d),
                        flops=2 * bb * cfg.n_heads * e * e * 4)
            b.elementwise("t.state_new", [rkv, state], "state_out",
                          flops_per_elem=2, out_shape=(bb, cfg.n_heads, e, e),
                          dtype_bytes=F32, out_kind=TensorKind.OUTPUT)
            y = b.contract("t.o", [ty, wo], "attn_out", (bb, 1, d),
                           2 * bb * d * d)
        else:
            k_cache = b.input("k_cache", (bb, z, kvh, e))
            v_cache = b.input("v_cache", (bb, z, kvh, e))
            wq = b.weight("attn.wq", (d, h * e))
            wk = b.weight("attn.wk", (d, kvh * e))
            wv = b.weight("attn.wv", (d, kvh * e))
            wo = b.weight("attn.wo", (h * e, d))
            q = b.contract("attn.q", [x_n1, wq], "q", (bb, 1, h, e),
                           2 * bb * d * h * e)
            b.contract("attn.kv_new", [x_n1, wk, wv], "kv_new",
                       (bb, 1, 2 * kvh, e), 4 * bb * d * kvh * e,
                       out_kind=TensorKind.OUTPUT)
            scores = b.contract("attn.scores", [q, k_cache], "scores",
                                (bb, h, 1, z), 2 * bb * h * z * e)
            probs = b.elementwise("attn.softmax", [scores], "probs",
                                  flops_per_elem=5)
            ctx = b.contract("attn.pv", [probs, v_cache], "ctx",
                             (bb, 1, h, e), 2 * bb * h * z * e)
            y = b.contract("attn.o", [ctx, wo], "attn_out", (bb, 1, d),
                           2 * bb * h * e * d)
        x_mid = b.elementwise("res1", [x, y], "x_mid", flops_per_elem=1)
        ln2_w = b.weight("ln2.w", (d,))
        x_n2 = b.elementwise("ln2", [x_mid, ln2_w], "x_n2", flops_per_elem=6)
        m = mlp_block(b, cfg, "mlp", x_n2, bb)
        b.elementwise("res2", [x_mid, m], "x_out", flops_per_elem=1,
                      out_kind=TensorKind.OUTPUT, out_shape=(bb, 1, d))
    return b.graph


# ---------------------------------------------------------------------------
# group -> kernel-shape selection (execution backends)
# ---------------------------------------------------------------------------
#
# A co-designed plan's fusion groups are *claims*: "these ops run as one
# tile-streaming pass through the explicit region".  The execution backends
# (`repro.exec`) make the claim real; this selection decides, per group,
# which kernel shape the claim lowers to:
#
#   ``stream`` — `pl.pallas_call` passes with a 1-D grid over row tiles of
#                the pass's shared streamed length; contraction right-hand
#                sides stay resident in VMEM across every tile (constant
#                index map), rank-0 dot/norm reductions accumulate across
#                grid steps, and scalar epilogues run once on the final
#                tile.  A group usually lowers to ONE pass; it splits into
#                sequential passes exactly where a contraction reads a
#                vector produced earlier in the same group (the value must
#                fully materialize before it can be a resident operand).
#   ``spmv-stream`` — a stream group whose passes include CSR SpMV ops:
#                the same 1-D row-tile grid, but the sparse operand's
#                indptr/indices/data triple AND the gathered x stay
#                resident in VMEM across every tile (rows are ragged and
#                column access is data-dependent); the output vector
#                streams row tiles.  With an overbooked (partial) pin the
#                residency is *fractional*: a :class:`ResidentSlice`
#                records the indptr-aligned row prefix held resident
#                while tail tiles stream their CSR slices per grid step.
#   ``block``  — one `pl.pallas_call` with whole arrays as single blocks:
#                stencil sweeps need halo rows, so they cannot row-stream
#                without overlap; the explicit region holds the full grid.
#   ``jnp``    — jitted jax.numpy fallback for shapes the streamer cannot
#                express (irregular gathers, scans, >2-operand einsums,
#                mixed streamed lengths); ``reason`` records why.

#: einsum specs the tile-streamer lowers: LHS streams row tiles, RHS stays
#: resident (spec -> index of the resident operand)
STREAM_EINSUMS = {"ab,b->a": 1, "ab,bc->ac": 1}
#: rank-0 contraction of two streamed vectors (rank-1 @ rank-1)
REDUCE_EINSUMS = ("a,a->",)

_TILE_ROW_CANDIDATES = (1024, 512, 256, 128, 64, 32, 16, 8, 4, 2, 1)


@dataclasses.dataclass(frozen=True)
class ResidentSlice:
    """A contiguous, indptr-aligned row window of one operand (or of the
    whole pass) held by a single residency domain.

    Two producers, one record:

    * **Overbooked pins** (``row0 == 0``): rows ``[0, rows)`` of the CSR
      operand (the ``entries`` first indices/data entries) are held in
      VMEM across every tile; the remaining ``total_rows - rows`` rows
      stream their CSR slices through the grid per step.  Produced from
      an overbooked pin's :class:`~repro.core.schedule.PartialPin`
      records.
    * **Mesh shards** (``row0 = k * rows``): shard ``k`` of a partitioned
      plan owns rows ``[row0, row0 + rows)`` of the global problem — the
      ``entries`` CSR entries starting at ``entry0``.  Produced by
      :func:`partition_plan`."""
    tensors: Tuple[str, ...]        # the triple members covered (in order)
    rows: int                       # rows in this window (indptr-aligned)
    total_rows: int
    entries: int                    # nnz entries inside the window
    total_entries: int
    row0: int = 0                   # first global row of the window
    entry0: int = 0                 # first global CSR entry of the window

    @property
    def frac(self) -> float:
        return self.rows / max(1, self.total_rows)

    def describe(self) -> str:
        if self.row0:
            return f"rows[{self.row0}:{self.row0 + self.rows}]"
        return f"prefix({self.rows}/{self.total_rows}r)"


@dataclasses.dataclass(frozen=True)
class StreamPass:
    """One tile-streaming pallas pass over a slice of a fusion group."""
    ops: Tuple[str, ...]
    rows: int                       # streamed leading-dim length
    tile_rows: int                  # rows per grid step (divides ``rows``)
    resident: Tuple[str, ...]       # operands held in VMEM across all tiles
    reductions: Tuple[str, ...]     # rank-0 accumulators in this pass
    # fractional residency of spmv operands (overbooked pins): members of
    # ``resident`` named here hold only their row prefix in VMEM
    slices: Tuple[ResidentSlice, ...] = ()


@dataclasses.dataclass(frozen=True)
class GroupKernel:
    """The kernel shape selected for one fusion group."""
    ops: Tuple[str, ...]
    kind: str                       # "stream" | "block" | "jnp"
    passes: Tuple[StreamPass, ...] = ()   # populated for kind == "stream"
    reason: str = ""                # why a jnp fallback was selected

    def describe(self) -> str:
        if self.kind in ("stream", "spmv-stream"):
            bits = []
            for p in self.passes:
                res = f" res={'+'.join(p.resident)}" if p.resident else ""
                red = f" acc={'+'.join(p.reductions)}" if p.reductions \
                    else ""
                part = "".join(f" {sl.describe()}" for sl in p.slices)
                bits.append(f"{p.rows}r/{p.tile_rows}t{res}{red}{part}")
            tag = " | ".join(bits)
            n = len(self.passes)
            label = ("pallas-spmv" if self.kind == "spmv-stream"
                     else "pallas-stream")
            return (f"{label}[{tag}]" if n == 1
                    else f"{label}[{n} passes: {tag}]")
        if self.kind == "block":
            return "pallas-block[halo ops, full-array block]"
        return f"jnp-fallback({self.reason})"


def _pick_tile_rows(rows: int, per_row_bytes: int, resident_bytes: int,
                    explicit_bytes: int) -> int:
    """Largest row tile (a divisor of ``rows``) whose streaming working set
    fits the explicit region.  The co-design's own fusion-legality check
    (`schedule.fusable`) guaranteed *some* tile fits; when the resident
    operands already cover (or exceed) the budget, we still stream — at
    the finest granularity, never a zero/negative tile."""
    budget = max(explicit_bytes - resident_bytes, 0)
    for t in _TILE_ROW_CANDIDATES:
        if t <= rows and rows % t == 0 and t * per_row_bytes <= budget:
            return t
    # over-budget fallback: the smallest divisor among the candidates
    # (1 divides everything, so this always exists and is positive)
    return next(t for t in reversed(_TILE_ROW_CANDIDATES)
                if t <= rows and rows % t == 0)


def select_group_kernels(graph: OpGraph, groups, explicit_bytes: int,
                         partial=None) -> Tuple[GroupKernel, ...]:
    """Pick a kernel shape for every fusion group of a frontend plan.

    Pure graph-level classification (shapes + op specs); the expression
    semantics needed to *execute* each shape live in ``repro.exec``.

    ``partial`` maps tensor names to
    :class:`~repro.core.schedule.PartialPin` records (an overbooked pin
    set's ``.partial``): spmv operands named there carry a
    :class:`ResidentSlice` on their pass instead of the whole-operand
    residency assumption.
    """
    return tuple(_select_one(graph, list(g), explicit_bytes, partial)
                 for g in groups)


def _finalizes_late(graph: OpGraph, op, late: set) -> bool:
    """True when ``op``'s value only exists on the pass's *final* grid step:
    rank-0 reductions (dot/norm/`a,a->` accumulate across tiles), and any
    scalar computed from one (the ``beta = rs'/rs`` epilogues)."""
    if graph.tensors[op.output].shape != ():
        return False
    if op.spec == "reduce" or op.is_einsum:
        return True
    return any(t in late for t in op.inputs)


def _segment_group(graph: OpGraph, group) -> list:
    """Split a group into streaming passes.  A new pass starts where an op
    needs a value that only exists once the current pass *completes*:

    * a contraction whose resident operand was produced earlier in the
      group (the vector must fully materialize before it can sit in VMEM),
    * a tiled op reading an in-pass rank-0 value that *finalizes on the
      last tile* — a reduction, or a scalar chained off one.  A scalar
      whose in-pass inputs are all tile-invariant (``nalpha = -alpha`` with
      ``alpha`` external) is recomputed per tile instead ("eager" scalar),
      so it does NOT force a pass break; this is what lets the residency
      planner fuse ``x``/``r`` updates with the neg/axpy glue between them.

    ``fusable()`` never emits groups that need the late-scalar break, but
    ``select_group_kernels`` is public API and must be safe for any group
    handed to it.
    """
    segments, cur, produced, late = [], [], set(), set()
    for oname in group:
        op = graph.ops[oname]
        needs_break = False
        if op.is_einsum and op.spec in STREAM_EINSUMS:
            needs_break = op.inputs[STREAM_EINSUMS[op.spec]] in produced
        if op.spec == "spmv":
            # every spmv operand (CSR triple + gathered x) sits resident,
            # so any of them produced in-pass must materialize first
            needs_break = any(t in produced for t in op.inputs)
        if not needs_break and graph.tensors[op.output].shape != ():
            needs_break = any(t in late for t in op.inputs)
        if needs_break and cur:
            segments.append(cur)
            cur, produced, late = [], set(), set()
        cur.append(oname)
        produced.add(op.output)
        if _finalizes_late(graph, op, late):
            late.add(op.output)
    if cur:
        segments.append(cur)
    return segments


def _select_one(graph: OpGraph, group, explicit_bytes: int,
                partial=None) -> GroupKernel:
    ops = [graph.ops[o] for o in group]
    gops = tuple(group)

    for op in ops:
        if op.irregular or op.spec in ("gather", "scan"):
            return GroupKernel(gops, "jnp",
                               reason=f"{op.name}: irregular/scan reuse")

    # stencil sweeps need halo rows -> whole-array block kernel; they may
    # chain with same-shape elementwise ops inside the group
    if any(op.spec == "stencil2d" for op in ops):
        shapes = {graph.tensors[op.output].shape for op in ops}
        if len(shapes) != 1 or not all(op.spec in ("stencil2d", "ew")
                                       for op in ops):
            return GroupKernel(gops, "jnp",
                               reason="stencil mixed with non-halo ops")
        return GroupKernel(gops, "block")

    passes = []
    for seg in _segment_group(graph, group):
        sp = _classify_pass(graph, seg, explicit_bytes, partial)
        if isinstance(sp, str):                    # rejection reason
            return GroupKernel(gops, "jnp", reason=sp)
        passes.append(sp)
    kind = ("spmv-stream" if any(op.spec == "spmv" for op in ops)
            else "stream")
    return GroupKernel(gops, kind, passes=tuple(passes))


def _classify_pass(graph: OpGraph, seg, explicit_bytes: int, partial=None):
    """One segment -> :class:`StreamPass`, or a rejection-reason string."""
    partial = partial or {}
    ops = [graph.ops[o] for o in seg]
    produced = {op.output for op in ops}
    rows = None
    per_row = 0
    resident = []
    reductions = []
    slices = []
    streamed_seen = set()

    def _stream(tname) -> bool:
        """Account ``tname`` as streamed; False on row-count clash."""
        nonlocal rows, per_row
        spec = graph.tensors[tname]
        n = spec.shape[0]
        if rows is None:
            rows = n
        elif rows != n:
            return False
        if tname not in streamed_seen:
            streamed_seen.add(tname)
            per_row += spec.bytes // max(1, n)
        return True

    for op in ops:
        oshape = graph.tensors[op.output].shape
        if op.is_einsum and op.spec in REDUCE_EINSUMS:
            if not all(_stream(t) for t in op.inputs):
                return f"{op.name}: mixed row counts"
            reductions.append(op.output)
        elif op.is_einsum:
            rhs = STREAM_EINSUMS.get(op.spec)
            if rhs is None:
                return f"{op.name}: einsum {op.spec!r} beyond the streamer"
            if op.inputs[rhs] in produced:
                return f"{op.name}: contraction RHS produced in-pass"
            if not _stream(op.inputs[1 - rhs]) or not _stream(op.output):
                return f"{op.name}: mixed row counts"
            if op.inputs[rhs] not in resident:
                resident.append(op.inputs[rhs])
        elif op.spec == "spmv":
            # CSR SpMV: the output vector streams row tiles; the operand
            # triple and the gathered x are held resident — rows are
            # ragged and column access is data-dependent.  An overbooked
            # pin relaxes this to a resident row *prefix* (ResidentSlice)
            # with tail tiles streaming their CSR slices per grid step.
            if any(t in produced for t in op.inputs):
                return f"{op.name}: spmv operand produced in-pass"
            if not _stream(op.output):
                return f"{op.name}: mixed row counts"
            for t in op.inputs:
                if t not in resident:
                    resident.append(t)
            part = tuple(t for t in op.inputs if t in partial)
            if part:
                pp = partial[part[0]]
                sl = ResidentSlice(tensors=part, rows=pp.rows,
                                   total_rows=pp.total_rows,
                                   entries=pp.entries,
                                   total_entries=pp.total_entries)
                if sl not in slices:
                    slices.append(sl)
        elif op.spec == "reduce":
            if any(len(graph.tensors[t].shape) != 1 for t in op.inputs):
                return f"{op.name}: non-vector reduction"
            if not all(_stream(t) for t in op.inputs):
                return f"{op.name}: mixed row counts"
            reductions.append(op.output)
        elif op.spec == "ew":
            if oshape == ():        # scalar epilogue (beta = rs'/rs, ...)
                continue
            for t in list(op.inputs) + [op.output]:
                if graph.tensors[t].shape == ():
                    continue        # broadcast scalar operand
                if graph.tensors[t].shape != oshape:
                    return f"{op.name}: operand shape mismatch"
                if not _stream(t):
                    return f"{op.name}: mixed row counts"
        else:
            return f"{op.name}: op spec {op.spec!r}"

    if rows is None:                # nothing streams: scalar-only group
        return "scalar-only group"

    part_names = {t for sl in slices for t in sl.tensors}
    res_bytes = sum(partial[t].resident_bytes if t in part_names
                    else graph.tensors[t].bytes for t in resident)
    tile = _pick_tile_rows(rows, per_row, res_bytes,
                           max(explicit_bytes, 1 << 20))
    return StreamPass(ops=tuple(seg), rows=rows, tile_rows=tile,
                      resident=tuple(resident), reductions=tuple(reductions),
                      slices=tuple(slices))


# ---------------------------------------------------------------------------
# execution planning: fused dispatch units, cross-pass residency, rolled loops
# ---------------------------------------------------------------------------
#
# ``select_group_kernels`` answers "what kernel shape does each fusion group
# lower to"; this layer answers "how does the whole plan execute as ONE
# program".  Three decisions live here:
#
#   * **units** — the flat dispatch sequence (stream groups contribute one
#     unit per pass);
#   * **residency planning** — adjacent units sharing the same streamed
#     length fuse into a single pass when no value must materialize between
#     them, so streamed operands are read once and resident operands are
#     carried across what used to be pass *and group* boundaries (the
#     execution image of the explicit region persisting across the group
#     order) instead of being re-streamed per unit;
#   * **rolled loops** — when the frontend recorded per-iteration bodies
#     (``Program.iteration``) and the scheduled unit sequence repeats them
#     verbatim, the repeated segment is described once plus a trip count,
#     so an executor can run it as ``lax.fori_loop`` over one compiled body
#     instead of dispatching every unrolled copy.

@dataclasses.dataclass(frozen=True)
class ExecUnit:
    """One execution dispatch unit: a streaming pass, a whole-array block
    kernel, or a jnp-fallback group slice."""
    ops: Tuple[str, ...]
    kind: str                           # "stream" | "block" | "jnp"
    sp: Optional[StreamPass] = None     # populated for kind == "stream"
    groups: Tuple[int, ...] = ()        # originating fusion-group indices
    fused: int = 1                      # pre-fusion units merged into this

    def describe(self) -> str:
        extra = ""
        if self.sp is not None:
            extra = f" {self.sp.rows}r/{self.sp.tile_rows}t"
            if self.sp.resident:
                extra += f" res={'+'.join(self.sp.resident)}"
            for sl in self.sp.slices:
                extra += f" {sl.describe()}"
        if self.fused > 1:
            extra += f" (fused x{self.fused})"
        return f"{self.kind}[{'+'.join(self.ops)}]{extra}"


@dataclasses.dataclass(frozen=True)
class ResidentSpan:
    """A tensor held resident (constant index map) over a unit range."""
    tensor: str
    first: int                          # first unit index (inclusive)
    last: int                           # last unit index (inclusive)


@dataclasses.dataclass(frozen=True)
class CarrySlot:
    """One loop-carried value of a rolled iteration segment."""
    update: str            # template node whose value advances the slot
    final: str             # unrolled name the slot holds after the loop
    init: Optional[str] = None   # pre-loop env name seeding the slot
    #                              (None: seed with zeros — the slot is
    #                              only read after its first update)
    read: Optional[str] = None   # name the template reads it as (None:
    #                              output-only slot, threaded for the final)


@dataclasses.dataclass(frozen=True)
class RolledLoop:
    """A detected repeated iteration segment of the unit sequence: units
    ``[first, first + per_iter)`` are the template body; executing it
    ``n_iters`` times with the carry rebinding below reproduces units
    ``[first, first + per_iter * n_iters)`` exactly."""
    first: int
    per_iter: int
    n_iters: int
    slots: Tuple[CarrySlot, ...]

    @property
    def stop(self) -> int:
        """Index one past the last unit the rolled segment replaces."""
        return self.first + self.per_iter * self.n_iters


def flatten_units(kernels) -> Tuple[ExecUnit, ...]:
    """The flat dispatch sequence of a kernel selection (stream groups
    contribute one unit per pass, in order)."""
    units: List[ExecUnit] = []
    for gi, gk in enumerate(kernels):
        if gk.kind in ("stream", "spmv-stream"):
            # spmv-stream passes dispatch exactly like plain stream passes
            # (the pass's ops carry the spmv-ness); the distinct group
            # kind only records which kernel family was selected
            for sp in gk.passes:
                units.append(ExecUnit(sp.ops, "stream", sp, (gi,)))
        else:
            units.append(ExecUnit(tuple(gk.ops), gk.kind, None, (gi,)))
    return tuple(units)


def _merge_candidate(graph: OpGraph, unit: ExecUnit) -> bool:
    """Streaming passes merge; so do scalar-only jnp groups (their rank-0
    chains become eager/epilogue scalars of the absorbing pass)."""
    if unit.kind == "stream":
        return True
    if unit.kind != "jnp":
        return False
    return all(graph.ops[o].spec == "ew" and not graph.ops[o].irregular
               and graph.tensors[graph.ops[o].output].shape == ()
               for o in unit.ops)


def fuse_units(graph: OpGraph, units, explicit_bytes: int,
               partial=None) -> Tuple[ExecUnit, ...]:
    """The cross-pass residency planner: greedily merge adjacent units into
    one streaming pass wherever re-segmentation proves no value has to
    materialize at the old boundary.  Merged units stream each operand once
    for all their ops and keep resident operands in place across the former
    pass/group boundaries instead of re-streaming them."""
    fused: List[ExecUnit] = []
    for unit in units:
        prev = fused[-1] if fused else None
        if (prev is not None and _merge_candidate(graph, prev)
                and _merge_candidate(graph, unit)):
            ops = list(prev.ops) + list(unit.ops)
            segs = _segment_group(graph, ops)
            if len(segs) == 1:
                sp = _classify_pass(graph, segs[0], explicit_bytes, partial)
                if isinstance(sp, StreamPass):
                    fused[-1] = ExecUnit(tuple(ops), "stream", sp,
                                         prev.groups + unit.groups,
                                         prev.fused + unit.fused)
                    continue
        fused.append(unit)
    return tuple(fused)


def resident_spans(units) -> Tuple[ResidentSpan, ...]:
    """Unit-index span each resident operand is held over."""
    first: Dict[str, int] = {}
    last: Dict[str, int] = {}
    for ui, unit in enumerate(units):
        if unit.sp is None:
            continue
        for t in unit.sp.resident:
            first.setdefault(t, ui)
            last[t] = ui
    return tuple(ResidentSpan(t, first[t], last[t]) for t in sorted(first))


def _build_sigma(program) -> Optional[Dict[str, str]]:
    """The iteration-successor renaming: node at position ``j`` of body
    ``i`` ↦ node at position ``j`` of body ``i+1``.  Only equal-length
    consecutive bodies contribute (GMRES's growing Arnoldi bodies simply
    produce a partial map the matcher then rejects)."""
    bodies = [list(b) for b in program.iteration_bodies()]
    if len(bodies) < 2:
        return None
    sigma: Dict[str, str] = {}
    for a, b in zip(bodies, bodies[1:]):
        if len(a) == len(b):
            sigma.update(zip(a, b))
    return sigma or None


def _unit_matches(program, sigma: Dict[str, str], ua: ExecUnit,
                  ub: ExecUnit) -> bool:
    """Is ``ub`` exactly the σ-image of ``ua``?  Ops map positionally
    through σ, node structure is identical, and every operand is either
    σ-renamed or the same loop-invariant name."""
    if ua.kind != ub.kind or len(ua.ops) != len(ub.ops):
        return False
    if (ua.sp is None) != (ub.sp is None):
        return False
    if ua.sp is not None and (ua.sp.rows != ub.sp.rows
                              or ua.sp.tile_rows != ub.sp.tile_rows):
        return False
    for o, o2 in zip(ua.ops, ub.ops):
        if sigma.get(o) != o2:
            return False
        na, nb = program.nodes[o], program.nodes[o2]
        if (na.op != nb.op or na.shape != nb.shape
                or na.dtype_bytes != nb.dtype_bytes
                or na.params != nb.params
                or len(na.inputs) != len(nb.inputs)):
            return False
        for ta, tb in zip(na.inputs, nb.inputs):
            if tb != sigma.get(ta, ta):
                return False
    return True


def detect_rolled_loop(program, units) -> Optional[RolledLoop]:
    """Find the repeated per-iteration segment of a scheduled unit sequence.

    ``program`` is an expression ``Program`` (duck-typed: needs
    ``iteration_bodies()``, ``nodes`` and ``outputs``) whose builders
    recorded the unrolled solver-iteration bodies.  Those bodies define the
    successor renaming σ (:func:`_build_sigma`); detection then *proves*
    unit-level periodicity — a period ``P`` and region where every unit is
    exactly the σ-image of the unit ``P`` places earlier — so it tolerates
    schedules that phase-shift work across iteration boundaries (BiCGStab's
    deferred ``x`` update).  Iteration 0 typically stays unrolled: CG's
    ``p0`` aliases ``r0``, so its wiring differs from every later
    iteration's.  Returns the roll with the largest unit savings, or
    ``None`` when no period survives the proof.
    """
    if program is None:
        return None
    sigma = _build_sigma(program)
    if sigma is None:
        return None
    total = len(units)

    best: Optional[Tuple[int, int, int, int]] = None   # (saved, first, P, n)
    for P in range(1, total // 2 + 1):
        # every maximal run of σ-matches units[t] -> units[t+P]: a run over
        # t ∈ [a, c] makes units[a, c+P+1) periodic with period P.  All
        # runs matter — the final unrolled iteration often schedules
        # differently (CG fuses the last x-update into it), leaving a
        # trivial run at the tail next to the real one
        t = total - P - 1
        while t >= 0:
            if not _unit_matches(program, sigma, units[t], units[t + P]):
                t -= 1
                continue
            c = t
            while t > 0 and _unit_matches(program, sigma,
                                          units[t - 1], units[t - 1 + P]):
                t -= 1
            a = t
            n = (c + P + 1 - a) // P     # whole periods in the region
            a = (c + P + 1) - P * n      # truncate the partial leading one
            saved = (n - 1) * P
            if n >= 2 and (best is None or saved > best[0]):
                best = (saved, a, P, n)
            t -= 1
    if best is None:
        return None
    _, first, P, n = best

    # carry slots: template reads whose σ-image the template itself
    # produces thread through the loop; σ-mapped reads produced elsewhere
    # defeat the roll; σ-less reads are loop-invariant
    template = units[first:first + P]
    products = [o for u in template for o in u.ops]
    prod_set = set(products)
    reads: List[str] = []
    for u in template:
        for o in u.ops:
            for t in program.nodes[o].inputs:
                if t not in prod_set and t not in reads:
                    reads.append(t)

    def sig_pow(name: str, k: int) -> Optional[str]:
        for _ in range(k):
            name = sigma.get(name)
            if name is None:
                return None
        return name

    final_of: Dict[str, str] = {}
    for o in products:
        f = sig_pow(o, n - 1)
        if f is None:
            return None
        final_of[o] = f

    slots: List[CarrySlot] = []
    updates: set = set()
    for t in reads:
        st = sigma.get(t)
        if st is None:
            continue                     # loop-invariant operand
        if st not in prod_set:
            return None                  # next-generation value produced
        #                                  outside the template
        slots.append(CarrySlot(update=st, final=final_of[st],
                               init=t, read=t))
        updates.add(st)

    # products the epilogue (or the program outputs) read must come from
    # the final rolled generation; thread them as output-only slots
    region_products = {o for u in units[first:first + P * n] for o in u.ops}
    needed_after = set(program.outputs)
    for u in units[first + P * n:]:
        for o in u.ops:
            needed_after.update(program.nodes[o].inputs)
    final_to_template = {f: o for o, f in final_of.items()}
    for f in sorted(needed_after & region_products):
        o = final_to_template.get(f)
        if o is None:
            return None                  # a mid-generation value escapes
        if o not in updates:
            updates.add(o)
            slots.append(CarrySlot(update=o, final=f, init=None,
                                   read=None))
    if not slots:
        return None                      # iterations that carry nothing
    return RolledLoop(first=first, per_iter=P, n_iters=n,
                      slots=tuple(slots))


@dataclasses.dataclass(frozen=True)
class ExecPlan:
    """Execution-level plan for one compiled frontend plan: the fused
    dispatch units, the residency spans they imply, and the rolled
    iteration segment (when one was proven)."""
    units: Tuple[ExecUnit, ...]
    roll: Optional[RolledLoop]
    spans: Tuple[ResidentSpan, ...]
    n_prefuse: int                      # unit count before residency fusion

    def describe(self) -> str:
        bits = [f"{len(self.units)} units"]
        if len(self.units) != self.n_prefuse:
            bits.append(f"fused from {self.n_prefuse} passes")
        if self.roll is not None:
            r = self.roll
            bits.append(f"units[u{r.first}..u{r.first + r.per_iter - 1}] "
                        f"rolled x{r.n_iters}")
        carried = [sp for sp in self.spans if sp.last > sp.first]
        if carried:
            bits.append("resident across units: " + ", ".join(
                f"{sp.tensor}[u{sp.first}..u{sp.last}]" for sp in carried))
        return "; ".join(bits)


def plan_execution(graph: OpGraph, kernels, explicit_bytes: int,
                   program=None, partial=None) -> ExecPlan:
    """Units → residency fusion → rolled-loop detection, in that order.
    ``program`` (the frontend expression DAG) is optional; without it the
    plan is straight-line.  ``partial`` carries the overbooked pin set's
    per-tensor :class:`~repro.core.schedule.PartialPin` records so merged
    passes keep their :class:`ResidentSlice` annotations."""
    units = flatten_units(kernels)
    n_pre = len(units)
    fused = fuse_units(graph, units, explicit_bytes, partial)
    roll = detect_rolled_loop(program, fused)
    return ExecPlan(units=fused, roll=roll, spans=resident_spans(fused),
                    n_prefuse=n_pre)


# ---------------------------------------------------------------------------
# mesh partitioning: contiguous row-block shards of an ExecPlan
# ---------------------------------------------------------------------------
#
# A co-designed :class:`ExecPlan` runs its streamed passes over one global
# leading dimension.  :func:`partition_plan` splits that dimension into K
# contiguous row blocks — one per device slot of a 1-D solver mesh —
# and proves the split is sound for every unit of the plan:
#
#   * dense streamed operands split into equal row blocks (a shard is a
#     :class:`ResidentSlice` with a nonzero ``row0``, reusing the
#     overbooked-pin machinery rather than re-inventing it);
#   * CSR operands split at *indptr-aligned* row boundaries: the exact
#     per-shard entry windows come from the deterministic pattern
#     generators (``frontends.sparse.row_counts``), padded to one static
#     per-shard width so every shard runs the same program;
#   * contraction right-hand sides and spmv ``x`` vectors are exchanged
#     whole (``all_gather``) before each pass — the gathered-x exchange;
#   * ``stencil2d`` sweeps exchange one halo row with each mesh neighbour
#     (``ppermute``) instead of gathering the grid;
#   * rank-0 dot/norm reductions combine per-shard partials with ``psum``
#     (the reference oracle instead gathers operands whole so its sharded
#     results stay bitwise-identical to the single-device rules).
#
# Shapes the row-block story cannot express raise
# :class:`PlanPartitionError` — loudly, at lower time, never at dispatch.

class PlanPartitionError(ValueError):
    """A co-designed plan cannot be split into contiguous row blocks."""


@dataclasses.dataclass(frozen=True)
class CsrShardLayout:
    """Static row-block split of one CSR operand triple.

    ``entry_starts[k]`` is the global CSR entry index of shard ``k``'s
    first row (``entry_starts[K] == nnz``) — by construction the value of
    ``indptr[k * rows_per_shard]``, so every boundary is indptr-aligned.
    At dispatch each shard slices ``pad_entries`` entries starting at its
    boundary out of the (zero-padded) global indices/data, so all shards
    share one static shape; positions past a shard's true window resolve
    to local row id ``rows_per_shard`` and are dropped by the same
    out-of-range mask the tile kernels already apply."""
    indptr: str
    indices: str
    data: str
    rows: int                        # global row count
    nnz: int                         # global stored entries
    entry_starts: Tuple[int, ...]    # len n_shards + 1, indptr-aligned
    pad_entries: int                 # static per-shard entry window
    slices: Tuple[ResidentSlice, ...]   # shard k's row/entry window

    def describe(self) -> str:
        blocks = "/".join(str(b - a) for a, b in
                          zip(self.entry_starts, self.entry_starts[1:]))
        return (f"csr[{self.data}: {self.rows}r {self.nnz}nnz -> "
                f"{blocks} entries, pad {self.pad_entries}]")


@dataclasses.dataclass(frozen=True)
class ShardedExecPlan:
    """A partitioned execution plan: the single-device plan, its localized
    (per-shard) twin, and everything an executor needs to wire the
    exchanges — which names are row-sharded, which get gathered whole,
    which ops halo-exchange, and which rank-0 values psum."""
    base: ExecPlan                   # global plan (unchanged)
    local: ExecPlan                  # per-shard plan: rows / tiles ÷ K
    n_shards: int
    axis: str                        # mesh axis name
    rows: int                        # global streamed leading dim
    shards: Tuple[ResidentSlice, ...]      # shard k's row block
    csr: Tuple[CsrShardLayout, ...]        # per CSR operand triple
    sharded: Tuple[str, ...]         # names split along their leading dim
    gathered: Tuple[str, ...]        # row-sharded names exchanged whole
    halo: Tuple[str, ...]            # ops needing halo exchange
    reduced: Tuple[str, ...]         # rank-0 values combined across shards

    @property
    def rows_per_shard(self) -> int:
        return self.rows // self.n_shards

    def is_sharded(self, name: str) -> bool:
        return name in self._sharded_set

    @property
    def _sharded_set(self):
        return set(self.sharded)

    def describe(self) -> str:
        bits = [f"{self.n_shards} shards x {self.rows_per_shard} rows "
                f"over '{self.axis}'"]
        if self.gathered:
            bits.append("gather=" + "+".join(self.gathered))
        if self.reduced:
            bits.append("psum=" + "+".join(self.reduced))
        if self.halo:
            bits.append("halo=" + "+".join(self.halo))
        for lay in self.csr:
            bits.append(lay.describe())
        return "; ".join(bits)


def _localize_tile(tile_rows: int, rows_loc: int) -> int:
    """The per-shard row tile: the global tile when it still divides the
    local row count, otherwise the largest divisor not exceeding it."""
    t = min(tile_rows, rows_loc)
    if rows_loc % t:
        t = math.gcd(t, rows_loc)
    return max(t, 1)


def _localize_pass(sp: StreamPass, n_shards: int) -> StreamPass:
    rows_loc = sp.rows // n_shards
    return dataclasses.replace(
        sp, rows=rows_loc, tile_rows=_localize_tile(sp.tile_rows, rows_loc))


def _csr_layout(program, node, n_shards: int) -> CsrShardLayout:
    """Indptr-aligned entry windows for one spmv's CSR triple, derived
    from the deterministic pattern meta on the triple's leaves."""
    from ..frontends.sparse import row_counts
    indptr, indices, data = node.inputs[:3]
    rows = int(node.shape[0])
    nnz = int(program.nodes[indices].shape[0])
    leaf = program.nodes[indptr]
    pattern = leaf.param("pattern")
    if pattern is None:
        raise PlanPartitionError(
            f"spmv '{node.name}': CSR operand '{data}' carries no pattern "
            f"meta; cannot compute indptr-aligned shard boundaries")
    try:
        counts = row_counts(pattern, rows,
                            density=leaf.param("density"),
                            bandwidth=leaf.param("bandwidth"))
    except Exception as e:                       # unknown pattern/params
        raise PlanPartitionError(
            f"spmv '{node.name}': unusable CSR pattern meta "
            f"({pattern!r}): {e}") from e
    cum = [0]
    for c in counts:
        cum.append(cum[-1] + int(c))
    if cum[-1] != nnz:
        raise PlanPartitionError(
            f"spmv '{node.name}': pattern meta predicts {cum[-1]} entries "
            f"but '{indices}' holds {nnz}")
    rows_loc = rows // n_shards
    starts = tuple(cum[k * rows_loc] for k in range(n_shards + 1))
    widest = max(b - a for a, b in zip(starts, starts[1:]))
    pad = max(8, -(-widest // 8) * 8)
    slices = tuple(
        ResidentSlice(tensors=(indptr, indices, data), rows=rows_loc,
                      total_rows=rows, entries=starts[k + 1] - starts[k],
                      total_entries=nnz, row0=k * rows_loc,
                      entry0=starts[k])
        for k in range(n_shards))
    return CsrShardLayout(indptr=indptr, indices=indices, data=data,
                          rows=rows, nnz=nnz, entry_starts=starts,
                          pad_entries=pad, slices=slices)


def partition_plan(exec_plan: ExecPlan, mesh_axes, *,
                   program) -> ShardedExecPlan:
    """Split a co-designed :class:`ExecPlan` into contiguous row blocks.

    ``mesh_axes`` is either the shard count ``K`` or an ``(axis, K)``
    pair naming the 1-D mesh axis.  ``program`` is the frontend
    expression :class:`~repro_torch.frontends.expr.Program` the plan was
    lowered from — partitioning needs its op/shape/CSR-meta view.

    Raises :class:`PlanPartitionError` for anything the row-block story
    cannot express: ragged row counts, einsums other than ``ab,b->a`` /
    ``a,a->``, irregular gathers/scans, overbooked partial pins
    (fractional residency and sharding both claim the row dimension),
    non-scalar jnp fallbacks, or CSR operands without consistent
    deterministic pattern meta."""
    axis, n_shards = (("shards", mesh_axes) if isinstance(mesh_axes, int)
                      else (mesh_axes[0], int(mesh_axes[1])))
    if n_shards < 1:
        raise PlanPartitionError(f"shard count must be >= 1, got {n_shards}")
    if program is None:
        raise PlanPartitionError(
            "partitioning needs the frontend expression program "
            "(plan was lowered without one)")

    rows: Optional[int] = None

    def claim_rows(n: int, what: str) -> None:
        nonlocal rows
        if rows is None:
            rows = n
        elif rows != n:
            raise PlanPartitionError(
                f"{what}: leading dim {n} != plan row dim {rows}; "
                f"mixed streamed lengths cannot share one row split")

    csr: Dict[str, CsrShardLayout] = {}
    gathered: List[str] = []
    halo: List[str] = []
    reduced: List[str] = []

    for unit in exec_plan.units:
        if unit.kind == "stream":
            sp = unit.sp
            if sp.slices:
                raise PlanPartitionError(
                    f"pass {'+'.join(sp.ops)} carries overbooked partial "
                    f"pins; fractional residency and mesh sharding both "
                    f"claim the row dimension — re-codesign with "
                    f"overbook=0 to shard")
            claim_rows(sp.rows, f"pass {'+'.join(sp.ops)}")
            for o in sp.ops:
                nd = program.nodes[o]
                if nd.op == "spmv":
                    data = nd.inputs[2]
                    if data not in csr:
                        csr[data] = _csr_layout(program, nd, n_shards)
                    x = nd.inputs[3]
                    if (program.nodes[x].shape
                            and program.nodes[x].shape[0] == sp.rows
                            and x not in gathered):
                        gathered.append(x)
                elif nd.op in ("matmul", "einsum") and nd.shape != ():
                    spec = nd.param("spec")
                    if spec != "ab,b->a":
                        raise PlanPartitionError(
                            f"op '{o}': einsum {spec!r} has no row-block "
                            f"split (only 'ab,b->a' contractions and "
                            f"'a,a->' reductions shard)")
                    rhs = nd.inputs[1]
                    if (program.nodes[rhs].shape
                            and program.nodes[rhs].shape[0] == sp.rows
                            and rhs not in gathered):
                        gathered.append(rhs)
                elif (nd.op in ("dot", "norm")
                      or (nd.op in ("matmul", "einsum")
                          and nd.shape == ())):
                    # rank-0 reductions over streamed vectors: per-shard
                    # partials combine with psum (scalar ew epilogues
                    # recompute replicated from those, no exchange)
                    if o not in reduced:
                        reduced.append(o)
        elif unit.kind == "block":
            for o in unit.ops:
                nd = program.nodes[o]
                claim_rows(nd.shape[0], f"block op '{o}'")
                if nd.op == "stencil2d":
                    halo.append(o)
        else:                                    # jnp fallback
            for o in unit.ops:
                nd = program.nodes[o]
                if nd.irregular or nd.op in ("gather", "scan"):
                    raise PlanPartitionError(
                        f"op '{o}' ({nd.op}) is data-dependent; "
                        f"irregular addressing has no contiguous row split")
                if nd.shape != ():
                    raise PlanPartitionError(
                        f"jnp-fallback op '{o}' produces shape "
                        f"{nd.shape}; only scalar fallbacks replicate")

    if rows is None:
        raise PlanPartitionError("plan has no streamed rows to shard")
    if rows % n_shards:
        raise PlanPartitionError(
            f"{rows} rows do not split evenly over {n_shards} shards")

    rows_loc = rows // n_shards
    csr_members = {m for lay in csr.values()
                   for m in (lay.indptr, lay.indices, lay.data)}
    sharded = tuple(
        n for n, nd in program.nodes.items()
        if nd.shape and nd.shape[0] == rows and n not in csr_members)

    local_units = tuple(
        dataclasses.replace(u, sp=_localize_pass(u.sp, n_shards))
        if u.kind == "stream" else u
        for u in exec_plan.units)
    local = dataclasses.replace(exec_plan, units=local_units)

    shards = tuple(
        ResidentSlice(tensors=(), rows=rows_loc, total_rows=rows,
                      entries=0, total_entries=0, row0=k * rows_loc)
        for k in range(n_shards))
    return ShardedExecPlan(
        base=exec_plan, local=local, n_shards=n_shards, axis=axis,
        rows=rows, shards=shards, csr=tuple(csr.values()),
        sharded=sharded, gathered=tuple(gathered), halo=tuple(halo),
        reduced=tuple(reduced))
