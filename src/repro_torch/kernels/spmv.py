"""B2 and B3 · CSR SpMV: the CUDA C++ kernels ``csrc/spmv.cu``, their plain
versions, and B3's arrangement.

B2 replaces ``repro/exec/pallas.py:595`` ``_spmv_row_tile``.  Each row's
products are added in ascending entry order from zero (no atomics, no
masked scan over all entries), in one of two forms that the C launcher
picks from the entries a row (:func:`spmv_shape` names the one it takes):
one thread a row, or, from about two dozen entries a row, the blocks form
(:func:`spmv_blocks_plain` repeats it in torch): a CTA owns the rows that
start in its ``B2_BLOCK_ENTRIES`` entries and each of its ``B2_WARPS``
warps those that start in its share; a warp reads its rows' entries
coalesced, gathers and multiplies them, and each row's lane adds them in
order.  See the source for the design, its bound, what the card measured
and what was tried.  The CUDA backend launches B2 on its own just before
the B1 pass that holds the spmv op, and the pass streams its output.

B2's lane form (:func:`spmv_lanes`) serves a batch of requests against
one operand: ``x`` and ``y`` carry a leading lane axis, a thread reads
each entry of its row once for 4 lanes (the row's 4 such threads share it
through L1), and each lane equals B2 on it alone.
B3's lane form (:func:`spmv_sliced_lanes`, ``csrc/spmv.cu::
spmv_tiled_lanes_kernel``) does the same for an operand with an
overbooked pin: a block stages tiles of ``B3_LANE_ROWS`` rows in windows
of ``B3_LANE_WINDOW`` entries, as B3 does, and its threads read each
staged entry for 4 lanes each, B2's lane layout; each lane equals B3 (and
B2) on it alone, bitwise.

B3 replaces ``:616`` ``_spmv_sliced_tile`` together with its arrangement,
``:300`` ``_StreamCall._arrange``.  An overbooked pin keeps an
indptr-aligned row prefix of a CSR operand resident and streams the rest.
:func:`arrange` decides, as the JAX package does, whether an spmv op runs
sliced at all and where the resident prefix ends.  B3 is a kernel of its
own, shaped like the TPU kernel: a block stages each tile of
``B3_TILE_ROWS`` rows' entries in shared memory with coalesced 16-byte
copies (windows of ``B3_WINDOW`` entries, double-buffered), then each
thread sums its row from there in B2's order, so the two agree bitwise.
The copies of tiles inside the prefix carry an L2 evict_last hint, the
tail's evict_first (see the source for the design and what the card
measured of the hint).  The prefix is the leading range of the CSR arrays
themselves, so no packed layout is built: the arrangement is static
(pattern meta only) and is made once, when the plan compiles.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import count, on_cuda

#: B2's blocks form: warps a CTA, and E, the entries whose row starts a CTA
#: owns (``kB2Warps``, ``kB2Entries`` in ``csrc/spmv.cu``)
B2_WARPS = 8
B2_BLOCK_ENTRIES = 8192
#: B3's rows a tile and entries a staged window (``kTileRows``, ``kWindow``
#: in ``csrc/spmv.cu``); a row longer than a window spans several
B3_TILE_ROWS = 128
B3_WINDOW = 4608
#: the same of B3's lane form (``kLaneTileRows``, ``kLaneWindow``)
B3_LANE_ROWS = 32
B3_LANE_WINDOW = 1152


def csr_row_ids(indptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """Row id (int64) of every stored CSR entry, from ``indptr``."""
    ent = torch.arange(nnz, dtype=indptr.dtype, device=indptr.device)
    return torch.searchsorted(indptr, ent, right=True) - 1


def spmv_plain(indptr: torch.Tensor, indices: torch.Tensor,
               data: torch.Tensor, x: torch.Tensor, rows: int
               ) -> torch.Tensor:
    """CSR SpMV by gather + segment sum: one product per stored entry,
    each row's products added in ascending entry order (on the CPU; on a
    CUDA device ``index_add_`` adds through atomics in no fixed order).
    Entries past ``indptr[rows]`` (a mesh shard's padded entry window) add
    to no row, as the kernel never reads them: their row id is ``rows``,
    one past the result."""
    seg = csr_row_ids(indptr, data.shape[0])
    contrib = data * x.index_select(0, indices.long())
    out = torch.zeros(rows + 1, dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, seg, contrib)[:rows]


def b2_block_rows(indptr: torch.Tensor, rows: int, entries: int,
                  share: int = B2_BLOCK_ENTRIES) -> torch.Tensor:
    """The rows that each range of ``share`` entries owns in B2's blocks
    form for ``entries`` (``data.numel()``) entries: the ``entries //
    B2_BLOCK_ENTRIES + 1`` CTAs at ``share = B2_BLOCK_ENTRIES``, their
    warps at ``B2_BLOCK_ENTRIES // B2_WARPS``.  Range ``b`` owns rows
    ``[out[b], out[b + 1])``, those whose first entry ``indptr[r]`` lies in
    ``[b share, (b + 1) share)`` (the kernel's searches of ``indptr``)."""
    ranges = (entries // B2_BLOCK_ENTRIES + 1) * (B2_BLOCK_ENTRIES // share)
    keys = torch.arange(ranges + 1, dtype=torch.int64,
                        device=indptr.device) * share
    return torch.searchsorted(indptr[:rows].long().contiguous(), keys)


def spmv_blocks_plain(indptr: torch.Tensor, indices: torch.Tensor,
                      data: torch.Tensor, x: torch.Tensor, rows: int,
                      step: int = 64) -> torch.Tensor:
    """B2's blocks form in torch: for each warp's rows (:func:`b2_block_rows`
    at its share), 32 rows at a time, their entries in steps of ``step``
    (64 or 128, as the launcher picks), each step's products, then each
    row's products of the step added to its sum in entry order; a row's
    sum starts from zero.  Entries past ``indptr[rows]`` belong to no
    row."""
    out = torch.zeros(rows, dtype=data.dtype, device=data.device)
    if rows == 0:
        return out
    owned = b2_block_rows(indptr, rows, data.shape[0],
                          B2_BLOCK_ENTRIES // B2_WARPS).tolist()
    ptr = indptr.long()
    for ra, rb in zip(owned[:-1], owned[1:]):
        for ga in range(ra, rb, 32):
            gb = min(ga + 32, rb)
            rs, re = ptr[ga:gb], ptr[ga + 1:gb + 1]
            acc = torch.zeros(gb - ga, dtype=data.dtype, device=data.device)
            for base in range(int(ptr[ga]), int(ptr[gb]), step):
                top = min(int(ptr[gb]), base + step)
                prod = data[base:top] * x[indices[base:top].long()]
                lo = rs.clamp(min=base) - base
                n = (re.clamp(max=top) - base - lo).clamp(min=0)
                for k in range(int(n.max())):
                    p = prod[(lo + k).clamp(max=top - base - 1)]
                    acc = torch.where(n > k, acc + p, acc)
            out[ga:gb] = acc
    return out


def spmv_sliced_plain(indptr: torch.Tensor, indices: torch.Tensor,
                      data: torch.Tensor, x: torch.Tensor, rows: int,
                      prefix_rows: int) -> torch.Tensor:
    """B3's plain version: ``y = A @ x``, each row's products added in
    ascending entry order from zero, one entry slot of every row per step:
    the kernel's order, on any device.  ``prefix_rows`` is where the
    kernel's resident prefix ends; it does not change the result."""
    return spmv_sliced_lanes_plain(indptr, indices, data, x[None], rows,
                                   prefix_rows)[0]


def spmv_sliced_lanes_plain(indptr: torch.Tensor, indices: torch.Tensor,
                            data: torch.Tensor, x: torch.Tensor, rows: int,
                            prefix_rows: int) -> torch.Tensor:
    """B3's lane form in torch, and with one lane B3's plain version:
    ``y[l] = A @ x[l]`` for lane-major ``x`` ``(L, n)``, every lane's
    products added in ascending entry order from zero, one entry slot of
    every row per step (the kernel's order, on any device)."""
    _check_prefix(rows, prefix_rows)
    out = torch.zeros((x.shape[0], rows), dtype=data.dtype,
                      device=data.device)
    nnz = data.shape[0]
    if nnz == 0 or rows == 0:
        return out
    start = indptr[:-1].long()
    counts = indptr[1:].long() - start
    for k in range(int(counts.max())):
        e = (start + k).clamp_(max=nnz - 1)
        prod = data[e] * x[:, indices[e].long()]
        out = torch.where(counts > k, out + prod, out)
    return out


def _check_csr(name, indptr, indices, data, x, rows, aligned) -> None:
    """The kernels' argument checks: int32 indices, one float dtype,
    ``rows`` rows, contiguous tensors, and (B3's staged copies) 16-byte
    aligned ``indices`` and ``data``."""
    if indptr.dtype != torch.int32 or indices.dtype != torch.int32:
        raise TypeError(f"{name} kernel takes int32 indptr/indices")
    if data.dtype != x.dtype or data.dtype not in (torch.float32,
                                                   torch.float64):
        raise TypeError(f"{name} kernel takes float32/float64 data and x of "
                        f"one dtype, got {data.dtype}, {x.dtype}")
    if indptr.shape != (rows + 1,) or indices.shape != data.shape:
        raise ValueError(f"{name}: indptr {tuple(indptr.shape)}, indices "
                         f"{tuple(indices.shape)}, data {tuple(data.shape)} "
                         f"do not describe {rows} rows")
    for t in (indptr, indices, data, x):
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous tensors")
    if aligned and (indices.data_ptr() | data.data_ptr()) % 16:
        raise ValueError(f"{name} kernel stages 16-byte chunks: indices "
                         "and data must start 16-byte aligned")


def spmv(indptr: torch.Tensor, indices: torch.Tensor, data: torch.Tensor,
         x: torch.Tensor, rows: int, prefix_rows: Optional[int] = None
         ) -> torch.Tensor:
    """``y = A @ x`` for the CSR operand ``(indptr, indices, data)``: B2,
    or B3 when ``prefix_rows`` gives the resident prefix of an overbooked
    pin (rows ``[0, prefix_rows)``, from :func:`arrange`)."""
    sliced = prefix_rows is not None
    if sliced:
        _check_prefix(rows, prefix_rows)
    if not on_cuda(indptr, indices, data, x):
        return (spmv_sliced_plain(indptr, indices, data, x, rows, prefix_rows)
                if sliced else spmv_plain(indptr, indices, data, x, rows))
    from .build import check, cuda_library
    name = "spmv_sliced" if sliced else "spmv"
    _check_csr(name, indptr, indices, data, x, rows, aligned=sliced)
    y = torch.empty(rows, dtype=x.dtype, device=x.device)
    suffix = "f32" if x.dtype == torch.float32 else "f64"
    fn = getattr(cuda_library(), f"cello_{name}_{suffix}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    count(name)
    check(fn(indptr.data_ptr(), indices.data_ptr(), data.data_ptr(),
             x.data_ptr(), y.data_ptr(), rows,
             prefix_rows if sliced else data.shape[0], stream), name)
    return y


def spmv_shape(rows: int, entries: int) -> dict:
    """The launch B2 takes for ``rows`` rows and ``entries``
    (``data.numel()``) entries, as the library built it: its form
    ("blocks" or "rows"), threads a CTA, CTAs, entries a warp's step and
    the entry range E whose row starts a CTA owns (0 for the rows form)."""
    import ctypes
    from .build import check, cuda_library
    out = (ctypes.c_int * 5)()
    check(cuda_library().cello_spmv_shape(rows, entries, out), "spmv_shape")
    return dict(form="blocks" if out[0] else "rows", threads=out[1],
                ctas=out[2], step=out[3], block_entries=out[4])


def spmv_lanes_plain(indptr: torch.Tensor, indices: torch.Tensor,
                     data: torch.Tensor, x: torch.Tensor, rows: int
                     ) -> torch.Tensor:
    """B2's lane form in torch: ``Y[l] = A @ x[l]`` for lane-major ``x``
    ``(L, n)``, every lane's products added in ascending entry order, as
    :func:`spmv_plain` adds them for one ``x`` (on the CPU)."""
    seg = csr_row_ids(indptr, data.shape[0])
    contrib = data * x.index_select(1, indices.long())
    out = torch.zeros((x.shape[0], rows), dtype=contrib.dtype,
                      device=contrib.device)
    return out.index_add_(1, seg, contrib)


def spmv_lanes(indptr: torch.Tensor, indices: torch.Tensor,
               data: torch.Tensor, x: torch.Tensor, rows: int
               ) -> torch.Tensor:
    """B2's lane form: ``y[l] = A @ x[l]`` for L right-hand sides at once,
    ``x`` lane-major ``(L, n)``, ``y`` ``(L, rows)``; a thread reads each
    entry of its row once for 4 lanes, and each lane equals :func:`spmv` on
    that lane alone, bitwise (see ``csrc/spmv.cu``)."""
    if x.dim() != 2:
        raise ValueError(f"spmv_lanes takes a lane-major (L, n) x, got "
                         f"{tuple(x.shape)}")
    if not on_cuda(indptr, indices, data, x):
        return spmv_lanes_plain(indptr, indices, data, x, rows)
    from .build import check, cuda_library
    _check_csr("spmv_lanes", indptr, indices, data, x, rows, aligned=False)
    lanes, cols = x.shape
    y = torch.empty((lanes, rows), dtype=x.dtype, device=x.device)
    suffix = "f32" if x.dtype == torch.float32 else "f64"
    fn = getattr(cuda_library(), f"cello_spmv_lanes_{suffix}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    count("spmv_lanes")
    check(fn(indptr.data_ptr(), indices.data_ptr(), data.data_ptr(),
             x.data_ptr(), y.data_ptr(), rows, cols, lanes, stream),
          "spmv_lanes")
    return y


def spmv_sliced_lanes(indptr: torch.Tensor, indices: torch.Tensor,
                      data: torch.Tensor, x: torch.Tensor, rows: int,
                      prefix_rows: int) -> torch.Tensor:
    """B3's lane form: ``y[l] = A @ x[l]`` for L right-hand sides at once,
    ``x`` lane-major ``(L, n)``, ``y`` ``(L, rows)``, against an operand
    whose rows ``[0, prefix_rows)`` are the resident prefix of an
    overbooked pin (from :func:`arrange`).  Each window of
    ``B3_LANE_WINDOW`` entries staged in shared memory serves a group of
    16 lanes, four lanes a thread, and each lane equals :func:`spmv` with
    that ``prefix_rows`` on that lane alone, bitwise.  The prefix is
    hinted in L2 as B3 hints it.
    Bound: bytes, the tail's entries, ``indptr`` and every lane's x and y
    with the prefix held in L2.  ``csrc/spmv.cu`` gives the design, its
    time on the card beside the earlier form's and B2 lanes', and the
    shapes tried and found slower."""
    if x.dim() != 2:
        raise ValueError(f"spmv_sliced_lanes takes a lane-major (L, n) x, "
                         f"got {tuple(x.shape)}")
    _check_prefix(rows, prefix_rows)
    if not on_cuda(indptr, indices, data, x):
        return spmv_sliced_lanes_plain(indptr, indices, data, x, rows,
                                       prefix_rows)
    from .build import check, cuda_library
    _check_csr("spmv_sliced_lanes", indptr, indices, data, x, rows,
               aligned=True)
    lanes, cols = x.shape
    y = torch.empty((lanes, rows), dtype=x.dtype, device=x.device)
    suffix = "f32" if x.dtype == torch.float32 else "f64"
    fn = getattr(cuda_library(), f"cello_spmv_sliced_lanes_{suffix}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    count("spmv_sliced_lanes")
    check(fn(indptr.data_ptr(), indices.data_ptr(), data.data_ptr(),
             x.data_ptr(), y.data_ptr(), rows, cols, lanes, prefix_rows,
             stream), "spmv_sliced_lanes")
    return y


def sliced_lanes_shape(dtype: torch.dtype) -> dict:
    """B3's lane form's launch shape on this card, as the library built
    it: rows a tile, threads and dynamic shared bytes a block, blocks an
    SM, SMs, entries a window, lanes a thread."""
    import ctypes
    from .build import check, cuda_library
    suffix = "f32" if dtype == torch.float32 else "f64"
    out = (ctypes.c_int * 7)()
    check(getattr(cuda_library(), f"cello_spmv_sliced_lanes_shape_{suffix}")(
        out), "spmv_sliced_lanes_shape")
    return dict(zip(("tile_rows", "threads", "shared_bytes", "blocks_per_sm",
                     "sms", "window", "lanes_per_thread"), out))


def arrange(sl, leaf, rows: int, tile_rows: int, nnz: int) -> Optional[int]:
    """The resident prefix (rows) of one prefix-sliced spmv op, or None
    where the JAX package falls back to its whole-resident kernel
    (``pallas.py:322-332``) and the op runs on B2: ``rows % tile_rows !=
    0``, no entries, no ``pattern`` param on the operand's indptr leaf (a
    hand-built program), pattern meta the generator refuses, or per-row
    counts that do not add up to ``nnz``.  The prefix is the whole row
    tiles that the slice covers, the boundary tile excluded
    (``pallas.py:346``).

    ``sl`` is the op's :class:`~repro_torch.core.lowering.ResidentSlice`,
    ``leaf`` the operand's indptr node (or None), ``rows`` and
    ``tile_rows`` the stream pass's."""
    from ..frontends.sparse import row_counts
    pattern = leaf.param("pattern") if leaf is not None else None
    if rows % tile_rows or nnz <= 0 or pattern is None:
        return None
    try:
        counts = row_counts(pattern, rows, density=leaf.param("density"),
                            bandwidth=leaf.param("bandwidth"))
    except (TypeError, ValueError):
        return None
    if int(counts.sum()) != nnz:
        return None
    return min(sl.rows // tile_rows, rows // tile_rows - 1) * tile_rows


def _check_prefix(rows: int, prefix_rows: int) -> None:
    if not 0 <= prefix_rows <= rows:
        raise ValueError(f"spmv_sliced: prefix_rows {prefix_rows} outside "
                         f"[0, {rows}]")
