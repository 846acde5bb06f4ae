"""B4 · periodic 5-point stencil: the CUDA C++ kernel ``csrc/stencil.cu``
and its plain version.

Replaces ``repro/exec/pallas.py:687`` ``_BlockCall._build`` for the
``stencil2d`` op (``repro/exec/reference.py:58-64``).  In the kernel each
warp walks a strip of rows down a tile of columns, with 16-byte vectors a
lane, the north, centre and south rows in registers and the west and east
neighbours from the next lanes by shuffles; a grid whose width is not a
multiple of the vector, or an operand not 16-byte aligned, takes the same
kernel's scalar path.  It keeps the reference's add order and roundings, so
it agrees with the plain version bitwise on either path; see the source for
the design and its bound.  Its lane form (:func:`stencil2d_lanes`) sweeps a
batch of grids in one launch, a grid axis over the lanes.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import count, on_cuda


def stencil2d_plain(u: torch.Tensor, f: Optional[torch.Tensor] = None,
                    h2: float = 1.0) -> torch.Tensor:
    """``0.25·(N+S+W+E) + (0.25·h2)·f`` with periodic boundaries, the
    neighbours added in the order of the JAX reference's rolls.  The grid
    is the last two axes: a leading lane axis of ``u`` or ``f`` (the lane
    form) sweeps each lane's grid alone."""
    out = 0.25 * (torch.roll(u, 1, -2) + torch.roll(u, -1, -2)
                  + torch.roll(u, 1, -1) + torch.roll(u, -1, -1))
    if f is not None:
        out = out + 0.25 * float(h2) * f
    return out


def stencil2d(u: torch.Tensor, f: Optional[torch.Tensor] = None,
              h2: float = 1.0, out: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """One sweep of ``u``; on CUDA the result goes to ``out`` when given
    (a buffer that must not alias ``u`` or ``f``)."""
    operands = (u,) if f is None else (u, f)
    if not on_cuda(*operands):
        return stencil2d_plain(u, f, h2)
    from .build import check, cuda_library
    if u.dim() != 2 or (f is not None and f.shape != u.shape):
        raise ValueError(f"stencil2d takes a 2-D u and an f of its shape, "
                         f"got {tuple(u.shape)}"
                         + ("" if f is None else f", {tuple(f.shape)}"))
    if u.dtype not in (torch.float32, torch.float64) or \
            (f is not None and f.dtype != u.dtype):
        raise TypeError("stencil2d kernel takes float32/float64 u and f "
                        "of one dtype")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("stencil2d kernel takes contiguous tensors")
    if out is None:
        out = torch.empty_like(u)
    elif (out.shape != u.shape or out.dtype != u.dtype
          or not out.is_contiguous()
          or any(out.data_ptr() == t.data_ptr() for t in operands)):
        raise ValueError("stencil2d out= must be a distinct contiguous "
                         "buffer of u's shape and dtype")
    fn = (cuda_library().cello_stencil2d_f32 if u.dtype == torch.float32
          else cuda_library().cello_stencil2d_f64)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    count("stencil2d")
    check(fn(u.data_ptr(), None if f is None else f.data_ptr(),
             out.data_ptr(), u.shape[0], u.shape[1], 0.25 * float(h2),
             stream), "stencil2d")
    return out


def stencil2d_lanes(u: torch.Tensor, f: Optional[torch.Tensor] = None,
                    h2: float = 1.0, out: Optional[torch.Tensor] = None,
                    *, lanes: int) -> torch.Tensor:
    """B4's lane form: one sweep of ``lanes`` grids in one launch.  ``u``
    and ``f`` are lane-major ``(lanes, n0, n1)`` or one ``(n0, n1)`` grid
    that every lane shares; the result is ``(lanes, n0, n1)`` (into
    ``out`` when given).  Each lane equals :func:`stencil2d` on it alone,
    bitwise."""
    operands = (u,) if f is None else (u, f)
    if not on_cuda(*operands):
        res = stencil2d_plain(u, f, h2)
        return res.expand(lanes, *res.shape[-2:]) if res.dim() == 2 else res
    from .build import check, cuda_library
    grid = tuple(u.shape[-2:])
    for t in operands:
        if t.shape not in ((lanes, *grid), grid):
            raise ValueError(f"stencil2d_lanes: operand {tuple(t.shape)} is "
                             f"neither ({lanes}, {grid[0]}, {grid[1]}) nor "
                             f"{grid}")
    if u.dtype not in (torch.float32, torch.float64) or \
            (f is not None and f.dtype != u.dtype):
        raise TypeError("stencil2d_lanes kernel takes float32/float64 u and "
                        "f of one dtype")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("stencil2d_lanes kernel takes contiguous tensors")
    if out is None:
        out = torch.empty((lanes, *grid), dtype=u.dtype, device=u.device)
    elif (out.shape != (lanes, *grid) or out.dtype != u.dtype
          or not out.is_contiguous()
          or any(out.data_ptr() == t.data_ptr() for t in operands)):
        raise ValueError("stencil2d_lanes out= must be a distinct "
                         "contiguous (lanes, n0, n1) buffer of u's dtype")
    fn = (cuda_library().cello_stencil2d_lanes_f32
          if u.dtype == torch.float32
          else cuda_library().cello_stencil2d_lanes_f64)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    count("stencil2d_lanes")
    check(fn(u.data_ptr(), None if f is None else f.data_ptr(),
             out.data_ptr(), grid[0], grid[1], 0.25 * float(h2), lanes,
             int(u.dim() == 3), int(f is not None and f.dim() == 3),
             stream), "stencil2d_lanes")
    return out
