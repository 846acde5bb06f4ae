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
n=4096 would leave 128 of the card's 132 SMs idle).  Matrix passes take 16
rows per program.  A ``(rows, C)`` tile wider than ``MAX_TILE_WIDTH`` (256)
columns is held and walked as chunks of at most 256 columns: elementwise
ops, loads and stores act chunk by chunk (a column's result depends on its
own column alone), an ``ab,bc->ac`` product keeps one accumulator a chunk
of C, and a product whose left operand is a tile of the block with K > 256
adds its K chunks' products in ascending order, as the plain version does.

**The streamed matvec** (``ab,b->a`` whose left operand streams from
memory: cg's ``A p``) adds, for every output row, its products in
``MATVEC_SLICES`` (32) interleaved slices of K: slice s takes the columns
k ≡ s (mod 32) in ascending k, each product rounded before its add, and
the 32 slice sums then fold through one fixed pairwise tree (:func:`_fold`).
A program keeps a rows × 32 accumulator, so every add is elementwise and
no K step reduces across threads, and it loads each K step one step ahead
of its adds.  A matrix pass's reductions fold their per-program partial
over the rows through the same kind of tree.  Both orders are fixed by the
text, not by Triton's layouts, which is what lets B1's lane form run a
group of lanes as one register tile and still equal the single request
bitwise, lane by lane (:class:`LaneStreamKernel`).

Bound on the H100: bytes.  A cg matvec pass at n=4096 in fp32 reads the
64 MiB operator once (about 20 us at 3.35 TB/s); the vector passes move a
few n-vectors, far below a microsecond of traffic at the main path's
sizes.  What the card said (H100 80GB HBM3, 700 W; ``chip_smoke.py``,
``PERF.md`` §6): with one cross-thread ``tl.sum`` a 128-column block,
cg's first matvec pass took 0.0313 ms fp32; with the slices and the step
loaded ahead it takes 0.0258 ms (78% of the bound) and 0.0470 ms fp64,
and the deferred pass at one K=4 shard's 1024 rows 0.0083 ms (0.0137
before).

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
#: rows per program for passes that stream a matrix
MATRIX_BLOCK_R = 16
#: the summation order of a streamed ``ab,b->a`` matvec in every form:
#: output i adds ``A[i, k] * x[k]`` for the k of slice s (k ≡ s mod
#: ``MATVEC_SLICES``) in ascending k, each product rounded, then the
#: slices fold through one fixed pairwise tree
MATVEC_SLICES = 32
#: columns of ``A`` a K step of the single-request matvec loads (a
#: multiple of ``MATVEC_SLICES``; the order above does not depend on it)
MATRIX_BLOCK_K = 256
#: lanes one program of B1's lane form carries when its pass streams an
#: operand without lanes (each tile of it is then read once for them all)
LANE_GROUP = 16
#: a lane group's matvec, per dtype: columns of ``A`` a K step loads for
#: the group, and warps a program (the fastest of the steps and warps
#: timed on the H100)
LANE_STEP = {torch.float32: (128, 8), torch.float64: (64, 4)}

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


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def _fold(x: str, lead: Tuple[int, ...], n: int, target: str) -> List[str]:
    """Lines that sum the last axis of ``x`` (shape ``(*lead, n)``, n a
    power of two >= 2) into ``target`` (shape ``lead``) through one fixed
    pairwise tree: elements 2i and 2i + 1 first, then those sums alike.
    Each level is an elementwise add, so the tree is the text's, whatever
    layout Triton gives ``x``."""
    assert n >= 2 and n & (n - 1) == 0, n
    lines = []
    while n > 2:
        n //= 2
        shape = ", ".join(str(d) for d in (*lead, n, 2))
        lines += [f"{x}_a, {x}_b = tl.split(tl.reshape({x}, ({shape})))",
                  f"{x} = {x}_a + {x}_b"]
    return lines + [f"{x}_a, {x}_b = tl.split({x})",
                    f"{target} = {x}_a + {x}_b"]


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
        self.streams_matrix = streams_matrix
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
                num_warps=self._warps(dtype), enable_fp_fusion=False)
        if self._fin_out:
            fin_ins = [env[n] for n in self._fin_scalar_in]
            count(self.names[1])
            _launch(self.names[1], fin, (1,), part, *fin_ins,
                    *[outs[n] for n in self._fin_out],
                    num_warps=4, enable_fp_fusion=False)
        return outs

    def _warps(self, dtype: torch.dtype) -> int:
        if (self.group or 1) > 1 and self.streams_matrix:
            return LANE_STEP[dtype][1]
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

        The single request, and a lane form of one lane a program, run one
        body (:meth:`_lane_body`; a lane's base pointer is the operand's
        plus the lane times its size), so such a lane's arithmetic, row
        blocks and reduction trees are the single request's.  A lane form
        of ``LANE_GROUP`` lanes a program runs :meth:`_group_body`: the
        same ops on ``(rows, lanes)`` tiles, each element rounded as the
        single request rounds it, with the operand without lanes loaded
        once a program."""
        fp32 = dtype == torch.float32
        tdt = "tl.float32" if fp32 else "tl.float64"
        lanes = self.group is not None
        group = self.group or 1
        var = {}

        def v(name: str, g: Optional[int] = None) -> str:
            if name not in var:
                var[name] = f"v{len(var)}"
            return var[name] if g is None else f"{var[name]}_{g}"

        def ptr(kind: str, name: str, g: Optional[int]) -> str:
            base = f"{kind}_{v(name)}"
            if g is None or name not in self.lanes:
                return base
            return f"({base} + l{g} * {_numel(self.shapes[name])})"

        def div(a: str, b: str, a_bc: bool, b_bc: bool, shape: str) -> str:
            if not fp32:
                return f"({a} / {b})"
            # div_rn takes tensors of one shape: broadcast the operands
            # flagged as narrower than the result
            if shape != "()":
                a = f"tl.broadcast_to({a}, {shape})" if a_bc else a
                b = f"tl.broadcast_to({b}, {shape})" if b_bc else b
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

        # ---- main kernel ----
        args = ([f"p_{v(n)}" for n in self.in_names]
                + [f"o_{v(n)}" for n in self.stream_out] + ["part"]
                + (["L"] if lanes else []))
        main = [f"pid = tl.program_id(0)",
                f"r = pid * {self.block_r} + tl.arange(0, {self.block_r})",
                f"rm = r < {self.rows}"]
        if group > 1:
            main += self._group_body(v, ew, tdt, LANE_STEP[dtype][0])
        else:
            if lanes:
                main.append("l0 = tl.program_id(1)")
            main += self._lane_body(0 if lanes else None, v, ptr, ew, tdt)

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
                j = self.red_out.index(nd.name)
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

    def _lane_body(self, g: Optional[int], v, ptr, ew, tdt) -> List[str]:
        """The main kernel's body for the single request (``g`` None) or
        for lane ``l<g>`` of a lane form of one lane a program: operands
        without lanes first, then the pass's ops in order."""
        br = self.block_r
        produced = self._produced
        shared: List[str] = []
        body: List[str] = []
        loaded: Set[str] = set()
        col_ranges: Set[str] = set()

        def width(name: str) -> Optional[int]:
            shape = self.shapes[name]
            return shape[1] if len(shape) == 2 else None

        def lane_var(name: str) -> str:
            return v(name, g if name in self.lanes else None)

        def cols(w: int) -> List[str]:
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
                shared.append(f"{name} = tl.arange(0, {pw})" if c0 == 0 else
                              f"{name} = {c0} + tl.arange(0, {pw})")
                shared.append(f"{name}m = {name} < {w}")
            return names

        def tile(name: str) -> List[str]:
            """The value of a streamed input or product in this block: one
            variable, or one a column chunk of a wide tile."""
            w = width(name)
            n = 1 if w is None else len(_chunks(w))
            chunks = [lane_var(name) if n == 1 else f"{lane_var(name)}_c{j}"
                      for j in range(n)]
            if name in produced or name in loaded:
                return chunks
            loaded.add(name)
            out = body if name in self.lanes else shared
            p = ptr("p", name, g)
            if w is None:
                out.append(f"{chunks[0]} = tl.load({p} + r, mask=rm, "
                           "other=0.0)")
                return chunks
            for var_, c in zip(chunks, cols(w)):
                out.append(f"{var_} = tl.load({p} + r[:, None] "
                           f"* {w} + {c}[None, :], mask=rm[:, None] & "
                           f"{c}m[None, :], other=0.0)")
            return chunks

        def scalar(name: str) -> str:
            if name not in produced and name not in loaded:
                loaded.add(name)
                (body if name in self.lanes else shared).append(
                    f"{lane_var(name)} = tl.load({ptr('p', name, g)})")
            return lane_var(name)

        def operand(name: str):
            """A scalar's variable, or a tile's (one a column chunk)."""
            return scalar(name) if self.shapes[name] == () else tile(name)

        def chunk_shape(name: str, j: int) -> str:
            w = width(name)
            return f"({br},)" if w is None else f"({br}, {_chunks(w)[j][1]})"

        for nd in self.nodes:
            cls = self.classes[nd.name]
            if cls == "eager":
                body.append(f"{v(nd.name, g)} = " + ew(
                    nd, [scalar(t) for t in nd.inputs],
                    [True] * len(nd.inputs), "()"))
            elif cls == "epilogue":
                continue
            elif cls == "reduce":
                if width(nd.inputs[0]) is not None:
                    raise NotImplementedError(
                        f"{nd.name}: a {nd.op} over a (rows, C) tile "
                        "in a stream pass")
                (a,) = tile(nd.inputs[0])
                (b,) = [a] if nd.op == "norm" else tile(nd.inputs[1])
                j = self.red_out.index(nd.name)
                slot = (f"{j} * {self.n_prog}" if g is None else
                        f"({j} * L + l{g}) * {self.n_prog}")
                prod = f"tl.where(rm, {a} * {b}, 0.0)"
                if not self.streams_matrix:
                    body.append(f"tl.store(part + {slot} + pid, "
                                f"tl.sum({prod}, axis=0))")
                    continue
                # a matrix pass: the fold of a lane group's form, whose
                # layout differs, fixed by the text
                t = f"{v(nd.name, g)}_t"
                body.append(f"{t} = {prod}")
                body.extend(_fold(t, (), br, t))
                body.append(f"tl.store(part + {slot} + pid, {t})")
            elif nd.op in ("matmul", "einsum"):
                body.extend(self._contraction(nd, g, v, ptr, tile, cols,
                                              tdt))
            else:
                ins = [operand(t) for t in nd.inputs]
                scal = [self.shapes[t] == () for t in nd.inputs]
                for j, out in enumerate(tile(nd.name)):
                    body.append(f"{out} = " + ew(
                        nd, [x if sc else x[j] for x, sc in zip(ins, scal)],
                        scal, chunk_shape(nd.name, j)))
            if nd.name in self.stream_out:
                w = width(nd.name)
                o = ptr("o", nd.name, g)
                if w is None:
                    body.append(f"tl.store({o} + r, {v(nd.name, g)}, "
                                "mask=rm)")
                    continue
                for out, c in zip(tile(nd.name), cols(w)):
                    body.append(f"tl.store({o} + r[:, None] * {w} + "
                                f"{c}[None, :], {out}, mask=rm[:, None] & "
                                f"{c}m[None, :])")
        return shared + body

    def _group_body(self, v, ew, tdt, bk: int) -> List[str]:
        """The main kernel's body for ``LANE_GROUP`` lanes a program: the
        pass's ops on ``(rows, lanes)`` tiles (a lane's scalars as a
        ``(lanes,)`` vector), operands without lanes loaded once and
        broadcast.  Every element is the single request's op on that
        lane's values; the streamed matvec is :meth:`_matvec` over the
        group; each reduction's partials fold over the rows through the
        single request's tree (:func:`_fold`), all lanes at once."""
        br, grp = self.block_r, self.group
        lines = [f"lg = tl.program_id(1) * {grp} + tl.arange(0, {grp})",
                 "lgm = lg < L"]
        shape = {"RG": f"({br}, {grp})", "R": f"({br},)",
                 "G": f"({grp},)", "S": "()"}
        kind: Dict[str, str] = {}

        def value(name: str) -> str:
            if name not in kind:
                lane, p = name in self.lanes, f"p_{v(name)}"
                if self.shapes[name] == ():
                    kind[name] = "G" if lane else "S"
                    src = (f"tl.load({p} + lg, mask=lgm, other=0.0)" if lane
                           else f"tl.load({p})")
                else:
                    kind[name] = "RG" if lane else "R"
                    src = (f"tl.load({p} + lg[None, :] * {self.rows} + "
                           "r[:, None], mask=rm[:, None] & lgm[None, :], "
                           "other=0.0)" if lane else
                           f"tl.load({p} + r, mask=rm, other=0.0)")
                lines.append(f"{v(name)} = {src}")
            return v(name)

        def joint(ks: List[str]) -> str:
            if "RG" in ks or {"R", "G"} <= set(ks):
                return "RG"
            return "R" if "R" in ks else "G" if "G" in ks else "S"

        def to(x: str, k: str, rk: str) -> str:
            if rk == "RG" and k in ("R", "G"):
                return f"{x}[:, None]" if k == "R" else f"{x}[None, :]"
            return x

        for nd in self.nodes:
            cls = self.classes[nd.name]
            if cls == "epilogue":
                continue
            if nd.op in ("matmul", "einsum"):
                rhs = STREAM_EINSUMS[nd.param("spec")]
                lines.extend(self._matvec(
                    nd, v(nd.name), tdt, f"p_{v(nd.inputs[1 - rhs])}",
                    f"p_{v(nd.inputs[rhs])}", grp, bk))
                kind[nd.name] = "RG"
            else:
                ins = nd.inputs if nd.op != "norm" else nd.inputs * 2
                vals = [value(t) for t in ins]
                ks = [kind[t] for t in ins]
                rk = joint(ks)
                args = [to(x, k, rk) for x, k in zip(vals, ks)]
                if cls == "reduce":
                    assert rk == "RG", (nd.name, ks)
                    t = f"{v(nd.name)}_t"
                    j = self.red_out.index(nd.name)
                    lines.append(f"{t} = tl.permute(tl.where(rm[:, None], "
                                 f"{args[0]} * {args[1]}, 0.0), (1, 0))")
                    lines.extend(_fold(t, (grp,), br, t))
                    lines.append(f"tl.store(part + ({j} * L + lg) * "
                                 f"{self.n_prog} + pid, {t}, mask=lgm)")
                    continue
                lines.append(f"{v(nd.name)} = " + ew(
                    nd, args, [k != rk for k in ks], shape[rk]))
                kind[nd.name] = rk
            if nd.name in self.stream_out:
                assert kind[nd.name] == "RG", (nd.name, kind[nd.name])
                lines.append(f"tl.store(o_{v(nd.name)} + lg[None, :] * "
                             f"{self.rows} + r[:, None], {v(nd.name)}, "
                             "mask=rm[:, None] & lgm[None, :])")
        return lines

    def _matvec(self, nd, out: str, tdt: str, pl: str, pr: str,
                group: Optional[int] = None,
                bk: Optional[int] = None) -> List[str]:
        """Lines of one ``ab,b->a`` product into ``out`` whose left operand
        (at ``pl``) streams from memory, in ``MATVEC_SLICES`` slices of K
        (see the constant): a ``(rows, slices)`` accumulator, or for a lane
        group (right-hand sides lane-major at ``pr``) a ``(rows, lanes,
        slices)`` one that reads each tile of the operand once for the
        group.  Every add is elementwise, no step reduces across threads,
        and each K step's tiles are loaded one step ahead of their adds.
        Each lane adds the single request's products in its order and
        folds its slices through the same tree, so it is bitwise the
        single-request product on it alone."""
        k = self.shapes[nd.inputs[STREAM_EINSUMS[nd.param("spec")]]][0]
        s, br = MATVEC_SLICES, self.block_r
        bk = bk or MATRIX_BLOCK_K
        assert bk % s == 0, (bk, s)
        steps = range(bk // s)
        lead = (br, group) if group else (br,)
        acc = f"{out}_s"
        lines = [f"{acc} = tl.zeros(({', '.join(map(str, lead))}, {s}), "
                 f"dtype={tdt})"]

        def loads(k0: str, nxt: str) -> List[str]:
            out_ = []
            for u in steps:
                first = (f"{k0} + " if k0 != "0" else "") + (
                    f"{u * s} + " if u else "")
                out_ += [f"kk{u} = {first}tl.arange(0, {s})",
                         f"km{u} = kk{u} < {k}",
                         f"a{u}{nxt} = tl.load({pl} + r[:, None] * {k} + "
                         f"kk{u}[None, :], mask=rm[:, None] & "
                         f"km{u}[None, :], other=0.0)",
                         f"b{u}{nxt} = tl.load({pr} + lg[:, None] * {k} + "
                         f"kk{u}[None, :], mask=lgm[:, None] & "
                         f"km{u}[None, :], other=0.0)" if group else
                         f"b{u}{nxt} = tl.load({pr} + kk{u}, mask=km{u}, "
                         "other=0.0)"]
            return out_

        lines += loads("0", "")
        lines.append(f"for k0 in range(0, {k}, {bk}):")
        lines += [f"    {ln}" for ln in loads(f"k0 + {bk}", "n")]
        prod = ("a{u}[:, None, :] * b{u}[None, :, :]" if group
                else "a{u} * b{u}[None, :]")
        lines += [f"    {acc} = {acc} + " + prod.format(u=u) for u in steps]
        lines += [f"    {x}{u} = {x}{u}n" for x in "ab" for u in steps]
        return lines + _fold(acc, lead, s, out)

    def _contraction(self, nd, g, v, ptr, tile, cols, tdt) -> List[str]:
        """Lines of one ``ab,b->a`` / ``ab,bc->ac`` product for a block of
        the single request or of lane ``g``."""
        spec = nd.param("spec")
        rhs = STREAM_EINSUMS[spec]
        lhs_n, rhs_n = nd.inputs[1 - rhs], nd.inputs[rhs]
        k = self.shapes[rhs_n][0]
        matvec = spec == "ab,b->a"
        lhs_tile = lhs_n in self._produced
        if matvec and not lhs_tile:
            return self._matvec(nd, v(nd.name, g), tdt, ptr("p", lhs_n, g),
                                ptr("p", rhs_n, g))
        lines: List[str] = []
        # fp32 products in full IEEE fp32 (no TF32); fp64 on the fp64 MMA
        dot_kw = ('input_precision="ieee"' if tdt == "tl.float32"
                  else "out_dtype=tl.float64")
        if not matvec:
            c = self.shapes[rhs_n][1]
            ccs = cols(c)
        pr = ptr("p", rhs_n, g)
        outs = [v(nd.name, g)] if matvec else tile(nd.name)
        if lhs_tile:
            # the left operand is a tile of this block: one product over
            # each column chunk of it (all of K when K <= MAX_TILE_WIDTH),
            # its padded columns zeroed, the chunks' products added in
            # ascending K (the plain version's order)
            kcs = cols(k)
            lhs = tile(lhs_n)
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
        # the left operand streams from memory: loop over K blocks of 16,
        # one accumulator a column chunk
        lines += [f"{out} = tl.zeros(({self.block_r}, {pw}), dtype={tdt})"
                  for out, (_c0, pw) in zip(outs, _chunks(c))]
        lines += [f"for k0 in range(0, {k}, 16):",
                  "    kk = k0 + tl.arange(0, 16)",
                  f"    km = kk < {k}",
                  f"    a = tl.load({ptr('p', lhs_n, g)} + r[:, None] * {k} "
                  "+ kk[None, :], mask=rm[:, None] & km[None, :], "
                  "other=0.0)"]
        for out, cc in zip(outs, ccs):
            lines.append(f"    b = tl.load({pr} + kk[:, None] * {c} + "
                         f"{cc}[None, :], mask=km[:, None] & "
                         f"{cc}m[None, :], other=0.0)")
            lines.append(f"    {out} += tl.dot(a, b, {dot_kw})")
        return lines


class LaneStreamKernel(StreamKernel):
    """B1's lane form: one launch runs the pass for ``L`` requests.

    Every product of the pass carries lanes, and so do the external
    operands named in ``lanes``; each such tensor is lane-major, its
    single-request shape behind a leading lane axis (``(L, rows)``,
    ``(L,)`` for a scalar).  Operands without lanes (the shared operator:
    cg's ``A``, jacobi_sparse's ``A.dinv``) are the single-request
    tensors.

    A pass that streams such an operand, and whose ops are vector ops, a
    streamed matvec of that operand and (in a matrix pass) reductions,
    runs ``LANE_GROUP`` lanes a program as ``(rows, lanes)`` tiles
    (:meth:`_group_body`): each tile of the shared operand is read once for
    the group, and a matvec ``A·x`` becomes ``A·[x_0 … x_15]`` as a rows ×
    16 lanes × 32 slices register tile (``LANE_STEP`` columns a K step).
    Every element is rounded as the single request rounds it, and the
    matvec's slices and the reductions' rows fold through the single
    request's trees, so each lane is bitwise the single-request pass on it
    alone.  Any other pass runs one lane a program on a second grid axis,
    the single-request body on the lane's operands.  The finalize kernel
    runs one program a lane.

    Bound on the H100: bytes, ``A`` once for 16 lanes.  The earlier form
    ran the single-request body 16 times in a program, one cross-thread
    ``tl.sum`` per lane and 128-column block: 0.2453 ms fp32 for cg's
    matvec pass at 16 lanes, 0.7309 ms fp64.  As one tile: 0.0446 ms fp32
    (45% of the bound, against 0.0557 for ``A @ X`` and its column dots in
    torch) and 0.0767 ms fp64 (H100 80GB HBM3, 700 W; ``chip_smoke.py``,
    ``PERF.md`` §6).  What stands in its way: Triton loads ``A``'s and the
    lanes' K steps coalesced and moves both through shared memory into the
    product's layout, with barriers, every K step.

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
        self.group = (LANE_GROUP if shared_streams and self._groups()
                      else 1)

    def _groups(self) -> bool:
        """Whether the pass runs as ``(rows, lanes)`` tiles: its tiles are
        vectors, its one kind of contraction an ``ab,b->a`` matvec of the
        operand without lanes, and its reductions (if any) fold over the
        rows by the text (a matrix pass; a vector pass's ``tl.sum`` tree
        follows its layout, which a lane group would not share)."""
        for nd in self.nodes:
            cls = self.classes[nd.name]
            if cls == "reduce" and not self.streams_matrix:
                return False
            if cls != "tiled":
                continue
            if nd.op in ("matmul", "einsum"):
                lhs = nd.inputs[1 - STREAM_EINSUMS[nd.param("spec")]]
                if (nd.param("spec") != "ab,b->a" or lhs in self._produced
                        or lhs in self.lanes):
                    return False
            elif any(len(self.shapes[t]) > 1 for t in (nd.name, *nd.inputs)):
                return False
        return True

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
                num_warps=self._warps(dtype), enable_fp_fusion=False)
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
