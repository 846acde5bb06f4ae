"""B1 · the fused row-streaming pass: generated Triton kernels and their
plain version.

Replaces ``repro/exec/pallas.py:427`` ``_StreamCall._build`` (inner
``kernel`` at :444, ``pallas_call`` at :534), with the node classes of
``_classify_nodes`` (:141), the cross-tile accumulation of ``_accumulate``
(:644) and the final-tile square root of ``_sqrt_at`` (:656).  One pass
computes, over the rows of its streamed length:

* tiled ops — add, sub, mul, div, neg, axpy on vectors (or on ``(rows, C)``
  matrices), ``ab,b->a`` matvecs and ``ab,bc->ac`` matmuls whose right-hand
  side is read whole by every program;
* reductions — dot and norm over the rows (and ``a,a->`` contractions);
* eager scalars — rank-0 glue whose inputs do not depend on the pass
  (``nalpha = -alpha``), computed in every program from device pointers;
* epilogue scalars — rank-0 glue over a reduction (``beta = rs'/rs``).

The TPU kernel ran its row tiles as a sequential grid and carried the
reduction sums from step to step in an output block.  Here the row blocks
run as parallel programs, so the pass is two generated kernels:

* the **main kernel**, one program per block of ``BLOCK_R`` rows, computes
  the tiled ops and writes one partial per reduction per program (no
  atomics);
* the **finalize kernel**, a single program, folds each reduction's
  partials in one fixed order (a tree over the partial vector), takes the
  square root of norms, recomputes the eager scalars, computes the epilogue
  scalars and writes the pass's scalar outputs.  The order never changes
  between runs, so results repeat bitwise from run to run.

**Deferred-finalize mode** (``defer_finalize=True``; replaces the
``defer_finalize`` switch of ``repro/exec/pallas.py:170``, ``:181-185``,
``:194-197``, ``:276``, ``:440-441``, ``:510``, ``:567-568``) is the pass
of one shard of a mesh-partitioned plan (``exec.sharded.ShardedProgram``):
it returns one **raw** sum per reduction, folded from its programs'
partials in the kernel's fixed order, and applies no square root to norms,
computes no epilogue scalar and writes no scalar output.  The sharded
program sums the shards' raw sums (``psum``), takes the square roots
(:attr:`StreamKernel.norm_reductions`) and replays the scalar chain
(:attr:`StreamKernel.finalize_nodes`).  Its main kernel is the pass's main
kernel; its finalize kernel is generated fold-only (the same tree over the
partial vector, one raw sum stored per reduction).  The fold stays on the
shard, rather than handing all K x programs partials to the combine,
because that is the contract of the TPU kernel: each shard's pass yields
one value per reduction, and the cross-shard sum is a fold over K values
in shard order.  So the combine is K - 1 adds whatever a shard's program
count, and a deferred pass's raw sum is bitwise the ordinary pass's
reduction on the same rows before its square root.  Launches count as
``stream_deferred`` and ``stream_deferred_finalize``.

Every pass has its own body, assembled from its node list, so the kernel
source is generated here, written under the build directory keyed by a hash
of its text, and imported; passes with the same structure share one
compiled kernel.  ``BLOCK_R`` is the kernel's own choice, not the plan's
``tile_rows`` (which the co-designer sized for a 128 MiB VMEM: 1024 rows at
n=4096 would leave 128 of the card's 132 SMs idle).  Matvec passes take 16
rows per program and loop over K in blocks of 128 columns.  A ``(rows, C)``
tile wider than ``MAX_TILE_WIDTH`` (256) columns is held and walked as
chunks of at most 256 columns: elementwise ops, loads and stores act chunk
by chunk (a column's result depends on its own column alone), an
``ab,bc->ac`` product keeps one accumulator a chunk of C, and a product
whose left operand is a tile of the block with K > 256 adds its K chunks'
products in ascending order, as the plain version does.  A tile of at most
256 columns generates the text it always did.

Bound on the H100: bytes.  A cg matvec pass at n=4096 in fp32 reads the
64 MiB operator once (about 20 us at 3.35 TB/s); the vector passes move a
few n-vectors.  At the sizes of the main path most passes are far below a
microsecond of traffic, so a ``run()`` of ~193 units is bound by launches,
not by the kernels (a CUDA graph over the run is the next step).

Rounding: fp32 division and square root use ``tl.div_rn`` / ``tl.sqrt_rn``
(IEEE, as torch's), and the kernels compile with ``enable_fp_fusion=False``
so ``a*x + y`` rounds the product as torch does.  fp64 passes accumulate in
fp64.  ``ab,bc->ac`` uses ``tl.dot`` with ``input_precision="ieee"`` in
fp32 (no TF32) and with fp64 operands and accumulator in fp64.
"""
from __future__ import annotations

import hashlib
import importlib.util
import os
import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch

from ..core.lowering import STREAM_EINSUMS
from . import count, on_cuda

#: widest column chunk of a ``(rows, C)`` tile that a program holds as one
#: Triton tensor; a wider tile is walked in chunks of this many columns
MAX_TILE_WIDTH = 256
#: rows per program for passes that stream a matrix, and the K block
MATRIX_BLOCK_R, MATRIX_BLOCK_K = 16, 128
#: lanes one program of B1's lane form carries when its pass streams an
#: operand without lanes (each tile of it is then read once for them all)
LANE_GROUP = 16

_TILED_EW = ("add", "sub", "mul", "div", "neg", "axpy")


def classify_nodes(nodes) -> Dict[str, str]:
    """"tiled" | "reduce" | "eager" | "epilogue" per node of one pass
    (``repro/exec/pallas.py:141`` ``_classify_nodes``)."""
    classes: Dict[str, str] = {}
    late: Set[str] = set()
    for nd in nodes:
        if nd.op in ("dot", "norm") or (nd.op in ("matmul", "einsum")
                                        and nd.shape == ()):
            classes[nd.name] = "reduce"
            late.add(nd.name)
        elif nd.shape == ():
            if any(t in late for t in nd.inputs):
                classes[nd.name] = "epilogue"
                late.add(nd.name)
            else:
                classes[nd.name] = "eager"
        else:
            classes[nd.name] = "tiled"
    return classes


def _p2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def _pw(w: int) -> int:
    """Padded tile width of a ``(rows, w)`` operand (``tl.dot`` takes
    dimensions of 16 or more)."""
    return max(16, _p2(w))


def _chunks(w: int) -> List[Tuple[int, int]]:
    """(first column, padded width) of each column chunk of a width-``w``
    tile: one chunk up to ``MAX_TILE_WIDTH`` columns, else chunks of
    ``MAX_TILE_WIDTH`` and a ragged last one."""
    return [(c0, _pw(min(MAX_TILE_WIDTH, w - c0)))
            for c0 in range(0, w, MAX_TILE_WIDTH)]


def _plain_op(op: str, ins):
    if op == "add":
        return ins[0] + ins[1]
    if op == "sub":
        return ins[0] - ins[1]
    if op == "mul":
        return ins[0] * ins[1]
    if op == "div":
        return ins[0] / ins[1]
    if op == "neg":
        return -ins[0]
    if op == "axpy":
        return ins[0] * ins[1] + ins[2]
    raise NotImplementedError(f"stream pass has no rule for op {op!r}")


class StreamKernel:
    """One fused pass: its generated Triton kernels and its plain version.

    ``nodes`` are the pass's ops in order (spmv ops excluded: the backend
    computes them with B2 first and hands their outputs in as streamed
    inputs); ``shapes`` maps every operand and product to its shape;
    ``needed`` names the products read after the pass; ``rows`` is the
    streamed length.

    ``lanes`` names the operands that carry a leading lane axis (one
    request each): given, this is B1's lane form (see
    :class:`LaneStreamKernel`); None is the single-request pass.
    """

    #: launch-count names of the main and finalize kernels
    names = ("stream", "stream_finalize")

    def __init__(self, nodes: Sequence, shapes: Dict[str, Tuple[int, ...]],
                 needed: Set[str], rows: int, *,
                 defer_finalize: bool = False):
        self.nodes = list(nodes)
        self.defer = defer_finalize
        if defer_finalize:
            self.names = ("stream_deferred", "stream_deferred_finalize")
        self.shapes = dict(shapes)
        self.rows = int(rows)
        self.classes = classify_nodes(self.nodes)
        produced = {nd.name for nd in self.nodes}
        stream_in: List[str] = []
        res_in: List[str] = []
        scalar_in: List[str] = []

        def want(name: str, bucket: List[str]):
            if name not in produced and name not in bucket:
                bucket.append(name)

        for nd in self.nodes:
            cls = self.classes[nd.name]
            if nd.op == "spmv":
                raise ValueError(f"{nd.name}: spmv runs as a B2 launch "
                                 "before the pass, not inside it")
            if cls == "tiled" and nd.op in ("matmul", "einsum"):
                rhs = STREAM_EINSUMS.get(nd.param("spec"))
                if rhs is None:
                    raise NotImplementedError(
                        f"{nd.name}: einsum {nd.param('spec')!r} is not a "
                        "streamed contraction")
                want(nd.inputs[1 - rhs], stream_in)
                want(nd.inputs[rhs], res_in)
            elif cls in ("tiled", "reduce"):
                if cls == "tiled" and nd.op not in _TILED_EW:
                    raise NotImplementedError(
                        f"{nd.name}: op {nd.op!r} in a stream pass")
                for t in nd.inputs:
                    want(t, scalar_in if self.shapes[t] == () else stream_in)
            else:
                for t in nd.inputs:
                    want(t, scalar_in)
        for t in stream_in:
            shape = self.shapes[t]
            if shape[0] != self.rows or len(shape) > 2:
                raise ValueError(f"{t}: shape {shape} does not stream "
                                 f"{self.rows} rows")
            # Triton offsets are int32
            assert self.rows * (shape[1] if len(shape) == 2 else 1) < 2 ** 31
        self.stream_in, self.res_in, self.scalar_in = \
            stream_in, res_in, scalar_in
        self._produced = produced
        self.red_out = [nd.name for nd in self.nodes
                        if self.classes[nd.name] == "reduce"]
        self.stream_out = [nd.name for nd in self.nodes
                           if self.classes[nd.name] == "tiled"
                           and nd.name in needed]
        self.scalar_out = [] if defer_finalize else [
            nd.name for nd in self.nodes
            if self.classes[nd.name] != "tiled" and nd.name in needed]
        streams_matrix = any(
            len(self.shapes[n]) == 2
            for nd in self.nodes if self.classes[nd.name] == "tiled"
            for n in (nd.name, *nd.inputs))
        # vector passes: 256-4096 rows a program, at most ~1024 programs
        self.block_r = (MATRIX_BLOCK_R if streams_matrix else
                        min(max(_p2(-(-self.rows // 1024)), 256), 4096))
        self.n_prog = -(-self.rows // self.block_r)
        self.lanes: Set[str] = set()      # operands with a lane axis
        self.group: Optional[int] = None  # lanes a program (lane form)
        self._kernels: Dict[torch.dtype, Tuple[object, object]] = {}

    # -- dispatch ---------------------------------------------------------
    @property
    def in_names(self) -> List[str]:
        """Each external operand once (a vector can stream and be a
        resident right-hand side in one pass)."""
        return list(dict.fromkeys(self.stream_in + self.res_in
                                  + self.scalar_in))

    def _shape(self, name: str, n_lanes: Optional[int]) -> Tuple[int, ...]:
        shape = tuple(self.shapes[name])
        return (n_lanes, *shape) if name in self.lanes else shape

    @property
    def out_names(self) -> List[str]:
        """What a call returns: the streamed products read after the pass,
        then its scalar outputs (deferred: every reduction's raw sum)."""
        return self.stream_out + self._fin_out

    @property
    def _fin_out(self) -> List[str]:
        """The finalize kernel's outputs."""
        return self.red_out if self.defer else self.scalar_out

    @property
    def finalize_nodes(self) -> list:
        """The scalar (eager and epilogue) nodes that a deferring caller
        replays after combining the reductions, in pass order."""
        return [nd for nd in self.nodes
                if self.classes[nd.name] in ("eager", "epilogue")]

    @property
    def norm_reductions(self) -> Set[str]:
        """The reductions whose deferred value is a sum of squares (the
        square root applies after the cross-shard sum)."""
        return {nd.name for nd in self.nodes
                if nd.op == "norm" and self.classes[nd.name] == "reduce"}

    def n_lanes(self, env) -> Optional[int]:
        """The lane count of ``env``'s lane operands (None when single)."""
        return None

    def __call__(self, env: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Run the pass over ``env``: the kernels for CUDA tensors, the
        plain version for CPU tensors."""
        ins = [env[n] for n in self.in_names]
        n_lanes = self.n_lanes(env)
        for n, t in zip(self.in_names, ins):
            if tuple(t.shape) != self._shape(n, n_lanes):
                raise ValueError(f"stream pass operand {n!r}: shape "
                                 f"{tuple(t.shape)}, expected "
                                 f"{self._shape(n, n_lanes)}")
        if on_cuda(*ins):
            return self.launch(env)
        return self.plain(env)

    # -- the plain version ------------------------------------------------
    def _plain_node(self, nd, ins: List[torch.Tensor]) -> torch.Tensor:
        """One node on single-request operands, the kernel's row blocks
        for a reduction's partials."""
        if self.classes[nd.name] == "reduce":
            a = ins[0]
            b = ins[1] if nd.op != "norm" else a
            prod = a.reshape(-1) * b.reshape(-1)
            pad = self.n_prog * self.block_r - prod.numel()
            parts = torch.nn.functional.pad(prod, (0, pad)).reshape(
                self.n_prog, self.block_r).sum(1)
            total = parts.sum()
            return (torch.sqrt(total) if nd.op == "norm" and not self.defer
                    else total)
        if nd.op in ("matmul", "einsum"):
            rhs = STREAM_EINSUMS[nd.param("spec")]
            a, b = ins[1 - rhs], ins[rhs]
            k = b.shape[0]
            if nd.inputs[1 - rhs] not in self._produced or k <= MAX_TILE_WIDTH:
                return a @ b
            # the kernel's order: the left tile's column chunks, ascending
            out = a[:, :MAX_TILE_WIDTH] @ b[:MAX_TILE_WIDTH]
            for k0 in range(MAX_TILE_WIDTH, k, MAX_TILE_WIDTH):
                k1 = k0 + MAX_TILE_WIDTH
                out = out + a[:, k0:k1] @ b[k0:k1]
            return out
        return _plain_op(nd.op, ins)

    def plain(self, env: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The pass in torch, with the kernel's row blocks for the
        reduction partials (deferred: raw sums, no epilogue)."""
        vals = {n: env[n] for n in self.in_names}
        for nd in self.nodes:
            if self.defer and self.classes[nd.name] == "epilogue":
                continue
            vals[nd.name] = self._plain_node(nd, [vals[t] for t in nd.inputs])
        return {n: vals[n] for n in self.out_names}

    # -- the kernels ------------------------------------------------------
    def _check_operands(self, ins) -> torch.dtype:
        dtype = ins[0].dtype
        for n, t in zip(self.in_names, ins):
            if t.dtype != dtype or not t.is_contiguous():
                raise ValueError(f"stream pass operand {n!r}: need "
                                 f"contiguous {dtype}, got {t.dtype}")
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"stream pass takes float32/float64, got {dtype}")
        return dtype

    def launch(self, env: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        ins = [env[n] for n in self.in_names]
        dtype = self._check_operands(ins)
        main, fin = self._compiled(dtype)
        dev = ins[0].device
        outs = {n: torch.empty(self.shapes[n], dtype=dtype, device=dev)
                for n in self.out_names}
        part = torch.empty((max(len(self.red_out), 1), self.n_prog),
                           dtype=dtype, device=dev)
        count(self.names[0])
        _launch(self.names[0], main, (self.n_prog,), *ins,
                *[outs[n] for n in self.stream_out], part,
                num_warps=self._warps, enable_fp_fusion=False)
        if self._fin_out:
            fin_ins = [env[n] for n in self._fin_scalar_in]
            count(self.names[1])
            _launch(self.names[1], fin, (1,), part, *fin_ins,
                    *[outs[n] for n in self._fin_out],
                    num_warps=4, enable_fp_fusion=False)
        return outs

    @property
    def _warps(self) -> int:
        return 8 if self.block_r >= 2048 else 4

    def _compiled(self, dtype: torch.dtype):
        hit = self._kernels.get(dtype)
        if hit is None:
            src = self.source(dtype)
            mod = _load_source(src)
            hit = self._kernels[dtype] = (mod.main_kernel,
                                          mod.finalize_kernel)
        return hit

    # -- code generation --------------------------------------------------
    @property
    def _fin_scalar_in(self) -> List[str]:
        if self.defer:
            return []
        used = {t for nd in self.nodes
                if self.classes[nd.name] in ("eager", "epilogue")
                for t in nd.inputs}
        return [n for n in self.scalar_in if n in used]

    def source(self, dtype: torch.dtype) -> str:
        """The Triton source of this pass at ``dtype`` (both kernels).

        In the lane form every lane of a program runs the single-request
        body on its own operands (a lane's base pointer is the operand's
        plus the lane times its size), so a lane's arithmetic, its row
        blocks and its reduction trees are the single-request pass's.
        Operands without lanes are loaded once a program, and a
        contraction whose streamed left operand has no lanes loads each
        tile of it once for all the program's lanes."""
        fp32 = dtype == torch.float32
        tdt = "tl.float32" if fp32 else "tl.float64"
        lanes = self.group is not None
        group = self.group or 1
        gs: List[Optional[int]] = list(range(group)) if lanes else [None]
        var = {}

        def v(name: str, g: Optional[int] = None) -> str:
            if name not in var:
                var[name] = f"v{len(var)}"
            return var[name] if g is None else f"{var[name]}_{g}"

        def lane_of(name: str, g: Optional[int]) -> Optional[int]:
            return g if name in self.lanes else None

        def numel(name: str) -> int:
            n = 1
            for s in self.shapes[name]:
                n *= s
            return n

        def ptr(kind: str, name: str, g: Optional[int]) -> str:
            base = f"{kind}_{v(name)}"
            g = lane_of(name, g)
            return base if g is None else f"({base} + l{g} * {numel(name)})"

        def div(a: str, b: str, a_sc: bool, b_sc: bool, shape: str) -> str:
            if not fp32:
                return f"({a} / {b})"
            # div_rn takes tensors of one shape: broadcast a scalar operand
            if a_sc and not b_sc:
                a = f"tl.broadcast_to({a}, {shape})"
            if b_sc and not a_sc:
                b = f"tl.broadcast_to({b}, {shape})"
            return f"tl.div_rn({a}, {b})"

        def ew(nd, args: List[str], scal: List[bool], shape: str) -> str:
            a = args
            if nd.op == "add":
                return f"({a[0]} + {a[1]})"
            if nd.op == "sub":
                return f"({a[0]} - {a[1]})"
            if nd.op == "mul":
                return f"({a[0]} * {a[1]})"
            if nd.op == "div":
                return div(a[0], a[1], scal[0], scal[1], shape)
            if nd.op == "neg":
                return f"(-{a[0]})"
            if nd.op == "axpy":
                return f"(({a[0]} * {a[1]}) + {a[2]})"
            raise NotImplementedError(nd.op)

        sqrt = "tl.sqrt_rn" if fp32 else "tl.sqrt"
        produced = {nd.name for nd in self.nodes}
        br = self.block_r

        def width(name: str) -> Optional[int]:
            shape = self.shapes[name]
            return shape[1] if len(shape) == 2 else None

        def chunk_shape(name: str, j: int) -> str:
            """The block shape of chunk ``j`` of ``name``'s tile."""
            w = width(name)
            return f"({br},)" if w is None else f"({br}, {_chunks(w)[j][1]})"

        # ---- main kernel ----
        args = ([f"p_{v(n)}" for n in self.in_names]
                + [f"o_{v(n)}" for n in self.stream_out] + ["part"]
                + (["L"] if lanes else []))
        head = [f"pid = tl.program_id(0)",
                f"r = pid * {br} + tl.arange(0, {br})",
                f"rm = r < {self.rows}"]
        if lanes:
            head.append(f"lb = tl.program_id(1) * {group}")
            head += [f"l{g} = lb + {g}" for g in gs]
        # lines run once a program (lanes: operands without lanes), then
        # each lane's lines; single-request passes use the lane list alone
        shared: List[str] = []
        per: Dict[Optional[int], List[str]] = {g: [] for g in gs}
        loaded: Set[Tuple[str, Optional[int]]] = set()
        col_ranges: Set[str] = set()

        def cols(w: int, out: List[str]) -> List[str]:
            """The column ranges of a width-``w`` tile: one, or one a chunk
            of ``MAX_TILE_WIDTH`` columns (the last one ragged)."""
            names = []
            chunks = _chunks(w)
            for j, (c0, pw) in enumerate(chunks):
                name = f"c{w}" if len(chunks) == 1 else f"c{w}_{j}"
                names.append(name)
                if name in col_ranges:
                    continue
                col_ranges.add(name)
                out.append(f"{name} = tl.arange(0, {pw})" if c0 == 0 else
                           f"{name} = {c0} + tl.arange(0, {pw})")
                out.append(f"{name}m = {name} < {w}")
            return names

        def target(name: str, g: Optional[int]) -> List[str]:
            return shared if lanes and name not in self.lanes else per[g]

        def tile(name: str, g: Optional[int]) -> List[str]:
            """The value of a streamed input or product in this block: one
            variable, or one a column chunk of a wide tile."""
            lg = lane_of(name, g)
            w = width(name)
            n = 1 if w is None else len(_chunks(w))
            chunks = [v(name, lg) if n == 1 else f"{v(name, lg)}_c{j}"
                      for j in range(n)]
            if name in produced or (name, lg) in loaded:
                return chunks
            loaded.add((name, lg))
            out = target(name, g)
            p = ptr("p", name, g)
            if w is None:
                out.append(f"{chunks[0]} = tl.load({p} + r, mask=rm, "
                           "other=0.0)")
                return chunks
            for var_, c in zip(chunks, cols(w, shared if lanes else out)):
                out.append(f"{var_} = tl.load({p} + r[:, None] "
                           f"* {w} + {c}[None, :], mask=rm[:, None] & "
                           f"{c}m[None, :], other=0.0)")
            return chunks

        def scalar(name: str, g: Optional[int]) -> str:
            lg = lane_of(name, g)
            if name in produced or (name, lg) in loaded:
                return v(name, lg)
            loaded.add((name, lg))
            target(name, g).append(f"{v(name, lg)} = "
                                   f"tl.load({ptr('p', name, g)})")
            return v(name, lg)

        def operand(name: str, g: Optional[int]):
            """A scalar's variable, or a tile's (one a column chunk)."""
            return (scalar(name, g) if self.shapes[name] == ()
                    else tile(name, g))

        red_index = {n: j for j, n in enumerate(self.red_out)}
        for nd in self.nodes:
            cls = self.classes[nd.name]
            if nd.op in ("matmul", "einsum") and cls == "tiled" and lanes:
                rhs_n = nd.inputs[STREAM_EINSUMS[nd.param("spec")]]
                lhs_n = nd.inputs[1 - STREAM_EINSUMS[nd.param("spec")]]
                if lhs_n not in produced and lhs_n not in self.lanes:
                    # the streamed left operand has no lanes: one K loop
                    # loads each of its tiles once for every lane
                    shared.extend(self._contraction(
                        nd, gs, v, ptr, tile, lambda w: cols(w, shared),
                        fp32, tdt, produced, guard=group > 1))
                    cls = "hoisted"
            for g in gs:
                body = per[g]
                if cls == "eager":
                    body.append(f"{v(nd.name, g)} = " + ew(
                        nd, [scalar(t, g) for t in nd.inputs],
                        [True] * len(nd.inputs), "()"))
                elif cls == "epilogue":
                    continue
                elif cls == "reduce":
                    if width(nd.inputs[0]) is not None:
                        raise NotImplementedError(
                            f"{nd.name}: a {nd.op} over a (rows, C) tile "
                            "in a stream pass")
                    (a,) = tile(nd.inputs[0], g)
                    (b,) = [a] if nd.op == "norm" else tile(nd.inputs[1], g)
                    j = red_index[nd.name]
                    slot = (f"{j} * {self.n_prog}" if not lanes else
                            f"({j} * L + l{g}) * {self.n_prog}")
                    body.append(f"tl.store(part + {slot} + pid, tl.sum("
                                f"tl.where(rm, {a} * {b}, 0.0), axis=0))")
                elif cls == "hoisted":
                    pass
                elif nd.op in ("matmul", "einsum"):
                    body.extend(self._contraction(
                        nd, [g], v, ptr, tile,
                        lambda w: cols(w, shared if lanes else body),
                        fp32, tdt, produced, guard=False))
                else:
                    ins = [operand(t, g) for t in nd.inputs]
                    scal = [self.shapes[t] == () for t in nd.inputs]
                    for j, out in enumerate(tile(nd.name, g)):
                        body.append(f"{out} = " + ew(
                            nd, [x if sc else x[j] for x, sc in zip(ins, scal)],
                            scal, chunk_shape(nd.name, j)))
                if nd.name in self.stream_out:
                    w = width(nd.name)
                    o = ptr("o", nd.name, g)
                    if w is None:
                        body.append(f"tl.store({o} + r, "
                                    f"{v(nd.name, g)}, mask=rm)")
                    else:
                        for out, c in zip(tile(nd.name, g),
                                          cols(w, shared if lanes else body)):
                            body.append(f"tl.store({o} + r[:, None] * {w}"
                                        f" + {c}[None, :], {out}, "
                                        f"mask=rm[:, None] & {c}m[None, :])")
        main = head + shared
        for g in gs:
            if group > 1:
                main.append(f"if l{g} < L:")
                main += [f"    {ln}" for ln in per[g]]
            else:
                main += per[g]

        # ---- finalize kernel ----
        # lanes: one program a lane, each the single-request finalize;
        # deferred: the fold alone, one raw sum stored per reduction
        fin_args = (["part"] + [f"p_{v(n)}" for n in self._fin_scalar_in]
                    + [f"o_{v(n)}" for n in self._fin_out]
                    + (["L"] if lanes else []))

        def fptr(kind: str, name: str) -> str:
            base = f"{kind}_{v(name)}"
            return f"({base} + lane)" if name in self.lanes else base

        npp = _p2(self.n_prog)
        fin = [f"i = tl.arange(0, {npp})", f"im = i < {self.n_prog}"]
        if lanes:
            fin.insert(0, "lane = tl.program_id(0)")
        for n in self._fin_scalar_in:
            fin.append(f"{v(n)} = tl.load({fptr('p', n)})")
        for nd in self.nodes:
            cls = self.classes[nd.name]
            if cls == "reduce":
                j = red_index[nd.name]
                slot = (f"{j} * {self.n_prog}" if not lanes else
                        f"({j} * L + lane) * {self.n_prog}")
                tot = (f"tl.sum(tl.load(part + {slot} + i, mask=im, "
                       "other=0.0), axis=0)")
                fin.append(f"{v(nd.name)} = " + (
                    f"{sqrt}({tot})" if nd.op == "norm" and not self.defer
                    else tot))
            elif cls in ("eager", "epilogue") and not self.defer:
                fin.append(f"{v(nd.name)} = " + ew(
                    nd, [v(t) for t in nd.inputs], [True] * len(nd.inputs),
                    "()"))
        for n in self._fin_out:
            fin.append(f"tl.store({fptr('o', n)}, {v(n)})")

        # a lane count is a plain argument: one compile serves every count
        jit = ('@triton.jit(do_not_specialize=["L"])' if lanes
               else "@triton.jit")

        def kernel(name, params, lines):
            return (f"{jit}\ndef {name}({', '.join(params)}):\n"
                    + "".join(f"    {ln}\n" for ln in lines))

        return ("import triton\nimport triton.language as tl\n\n\n"
                + kernel("main_kernel", args, main) + "\n\n"
                + kernel("finalize_kernel", fin_args, fin))

    def _contraction(self, nd, gs, v, ptr, tile, cols, fp32, tdt, produced,
                     guard: bool):
        """Lines of one ``ab,b->a`` / ``ab,bc->ac`` product for a block,
        for each lane of ``gs`` (None: the single request) with one K loop:
        the left operand's tile is loaded once for all of them; ``guard``
        skips the lanes past ``L``."""
        spec = nd.param("spec")
        rhs = STREAM_EINSUMS[spec]
        lhs_n, rhs_n = nd.inputs[1 - rhs], nd.inputs[rhs]
        k = self.shapes[rhs_n][0]
        lines: List[str] = []
        matvec = spec == "ab,b->a"
        # fp32 products in full IEEE fp32 (no TF32); fp64 on the fp64 MMA
        dot_kw = ('input_precision="ieee"' if fp32
                  else "out_dtype=tl.float64")
        if not matvec:
            c = self.shapes[rhs_n][1]
            ccs = cols(c)
        if lhs_n in produced:
            # the left operand is a tile of this block: one product over
            # each column chunk of it (all of K when K <= MAX_TILE_WIDTH),
            # its padded columns zeroed, the chunks' products added in
            # ascending K (the plain version's order)
            (g,) = gs
            outs = [v(nd.name, g)] if matvec else tile(nd.name, g)
            pr = ptr("p", rhs_n, g)
            kcs = cols(k)
            lhs = tile(lhs_n, g)
            for oi, out in enumerate(outs):
                for kc, lt in zip(kcs, lhs):
                    a = f"tl.where({kc}m[None, :], {lt}, 0.0)"
                    if matvec:
                        term = (f"tl.sum({a} * tl.load({pr} + {kc}, "
                                f"mask={kc}m, other=0.0)[None, :], axis=1)")
                    else:
                        cc = ccs[oi]
                        b = (f"tl.load({pr} + {kc}[:, None] * {c} + "
                             f"{cc}[None, :], mask={kc}m[:, None] & "
                             f"{cc}m[None, :], other=0.0)")
                        term = f"tl.dot({a}, {b}, {dot_kw})"
                    lines.append(f"{out} = {term}" if kc == kcs[0] else
                                 f"{out} = {out} + {term}")
            return lines
        # the left operand streams from memory: loop over K blocks
        bk = MATRIX_BLOCK_K if matvec else 16
        pl = ptr("p", lhs_n, gs[0])
        # the accumulators of each lane: one, or one a column chunk
        accs = {g: [v(nd.name, g)] if matvec else tile(nd.name, g)
                for g in gs}
        shapes = ([f"({self.block_r},)"] if matvec else
                  [f"({self.block_r}, {pw})" for _c0, pw in _chunks(c)])
        lines += [f"{acc} = tl.zeros({shape}, dtype={tdt})"
                  for g in gs for acc, shape in zip(accs[g], shapes)]
        lines += [f"for k0 in range(0, {k}, {bk}):",
                  f"    kk = k0 + tl.arange(0, {bk})",
                  f"    km = kk < {k}",
                  f"    a = tl.load({pl} + r[:, None] * {k} + kk[None, :], "
                  "mask=rm[:, None] & km[None, :], other=0.0)"]
        for g in gs:
            pr = ptr("p", rhs_n, g)
            ind = "    "
            if guard:
                lines.append(f"    if l{g} < L:")
                ind = "        "
            if matvec:
                (out,) = accs[g]
                lines += [f"{ind}b = tl.load({pr} + kk, mask=km, other=0.0)",
                          f"{ind}{out} += tl.sum(a * b[None, :], axis=1)"]
                continue
            for out, cc in zip(accs[g], ccs):
                lines.append(f"{ind}b = tl.load({pr} + kk[:, None] * {c} + "
                             f"{cc}[None, :], mask=km[:, None] & "
                             f"{cc}m[None, :], other=0.0)")
                lines.append(f"{ind}{out} += tl.dot(a, b, {dot_kw})")
        return lines


class LaneStreamKernel(StreamKernel):
    """B1's lane form: one launch runs the pass for ``L`` requests.

    Every product of the pass carries lanes, and so do the external
    operands named in ``lanes``; each such tensor is lane-major, its
    single-request shape behind a leading lane axis (``(L, rows)``,
    ``(L,)`` for a scalar).  Operands without lanes (the shared operator:
    cg's ``A``, jacobi_sparse's ``A.dinv``) are the single-request
    tensors.  A pass that streams such an operand runs ``LANE_GROUP``
    lanes a program, so each of its tiles is read once for the group (a
    matvec ``A·x`` becomes ``A·[x_0 … x_15]``); any other pass runs one
    lane a program on a second grid axis.  Either way every lane runs the
    single-request body on its own operands (see :meth:`source`), and
    its finalize kernel runs one program a lane.

    The plain version computes elementwise ops over the lane axis at
    once and each reduction and contraction lane by lane with the
    single-request pass's own rule, so it equals, bitwise, a loop of the
    single-request plain version over the lanes.
    """

    names = ("stream_lanes", "stream_lanes_finalize")

    def __init__(self, nodes: Sequence, shapes: Dict[str, Tuple[int, ...]],
                 needed: Set[str], rows: int, lanes: Set[str]):
        super().__init__(nodes, shapes, needed, rows)
        produced = {nd.name for nd in self.nodes}
        self.lanes = {n for n in self.in_names if n in lanes} | produced
        for nd in self.nodes:
            if not any(t in self.lanes for t in nd.inputs):
                raise ValueError(f"{nd.name}: no input carries lanes; a "
                                 "lane-independent node runs once, in the "
                                 "single-request pass")
        shared_streams = [t for t in self.stream_in if t not in self.lanes]
        self.group = LANE_GROUP if shared_streams else 1

    def n_lanes(self, env) -> int:
        counts = {int(env[n].shape[0]) for n in self.in_names
                  if n in self.lanes}
        if len(counts) != 1:
            raise ValueError(f"lane pass operands disagree on the lane "
                             f"count: {sorted(counts)}")
        (n,) = counts
        return n

    def plain(self, env: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        n_lanes = self.n_lanes(env)
        vals = {n: env[n] for n in self.in_names}
        for nd in self.nodes:
            ins = [vals[t] for t in nd.inputs]
            has = [t in self.lanes for t in nd.inputs]
            if (self.classes[nd.name] == "reduce"
                    or nd.op in ("matmul", "einsum")):
                vals[nd.name] = torch.stack([
                    self._plain_node(nd, [x[i] if h else x
                                          for x, h in zip(ins, has)])
                    for i in range(n_lanes)])
            else:
                rank = len(self.shapes[nd.name])
                vals[nd.name] = _plain_op(nd.op, [
                    x.reshape(*x.shape, *(1,) * (rank + 1 - x.dim()))
                    if h else x for x, h in zip(ins, has)])
        return {n: vals[n] for n in self.stream_out + self.scalar_out}

    def launch(self, env: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        ins = [env[n] for n in self.in_names]
        dtype = self._check_operands(ins)
        n_lanes = self.n_lanes(env)
        big = max((torch.Size(self.shapes[n]).numel() for n in self.lanes),
                  default=1)
        if n_lanes * big >= 2 ** 31:         # lane offsets are int32
            raise ValueError(f"{n_lanes} lanes of {big} elements overflow "
                             "the pass's int32 offsets")
        main, fin = self._compiled(dtype)
        dev = ins[0].device
        outs = {n: torch.empty((n_lanes, *self.shapes[n]), dtype=dtype,
                               device=dev)
                for n in self.stream_out + self.scalar_out}
        part = torch.empty((max(len(self.red_out), 1), n_lanes, self.n_prog),
                           dtype=dtype, device=dev)
        count(self.names[0])
        _launch(self.names[0], main, (self.n_prog, -(-n_lanes // self.group)),
                *ins, *[outs[n] for n in self.stream_out], part, n_lanes,
                num_warps=self._warps, enable_fp_fusion=False)
        if self.scalar_out:
            fin_ins = [env[n] for n in self._fin_scalar_in]
            count(self.names[1])
            _launch(self.names[1], fin, (n_lanes,), part, *fin_ins,
                    *[outs[n] for n in self.scalar_out], n_lanes,
                    num_warps=4, enable_fp_fusion=False)
        return outs


def _launch(name: str, kernel, grid, *args, **kwargs) -> None:
    """One Triton launch (compiling the kernel on its first): a compile or
    launch that fails raises ``KernelError``."""
    from .build import KernelError
    try:
        kernel[grid](*args, **kwargs)
    except Exception as e:
        raise KernelError(f"{name}: the Triton kernel did not build or "
                          f"launch: {type(e).__name__}: {e}") from e


_modules: Dict[str, object] = {}
_modules_lock = threading.Lock()


def _load_source(src: str):
    """Import generated Triton source from the build directory (written
    once per distinct text).  Triton itself is imported here, never at
    module import: the CPU tests import this module without it."""
    from .build import KernelError, build_dir, import_triton
    digest = hashlib.sha256(src.encode()).hexdigest()[:20]
    with _modules_lock:
        mod = _modules.get(digest)
        if mod is not None:
            return mod
        import_triton()
        gen = build_dir() / "triton"
        gen.mkdir(parents=True, exist_ok=True)
        path = gen / f"stream_{digest}.py"
        if not path.exists():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            tmp.write_text(src)
            os.replace(tmp, path)
        spec = importlib.util.spec_from_file_location(
            f"cello_stream_{digest}", path)
        mod = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(mod)
        except Exception as e:
            raise KernelError(f"generated Triton source {path.name} does "
                              f"not load: {type(e).__name__}: {e}") from e
        _modules[digest] = mod
        return mod
