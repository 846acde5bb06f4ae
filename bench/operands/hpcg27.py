"""HPCG's operator: the 27-point stencil of an ``nx x ny x nz`` grid, in CSR
with 27 slots a row.

As HPCG's ``GenerateProblem`` defines it (HPCG Technical Specification,
Sandia report SAND2013-8752, section 3): row ``r = (iz * ny + iy) * nx +
ix`` holds ``26`` on the diagonal and ``-1`` for each of its up to 26 grid
neighbours, columns in increasing order.  A row on the grid's boundary has
fewer neighbours; its free slots hold an explicit ``0`` at the diagonal's
column (ELLPACK's padding), so every row stores 27 entries, as the
program's operand leaves are sized.  The values do not depend on the seed.
Built with whole-array torch operations on ``device``.
"""
from __future__ import annotations

import torch

SLOTS = 27


def grid(cfg: dict):
    """The configuration's ``grid``, checked against its ``n``."""
    nx, ny, nz = (int(v) for v in cfg["grid"])
    n = int(cfg["params"]["n"])
    if nx * ny * nz != n:
        raise ValueError(f"hpcg27: grid {nx}x{ny}x{nz} is not n = {n} rows")
    return nx, ny, nz


def nonzeros(cfg: dict) -> int:
    """The operator's nonzeros, the padding left out."""
    nx, ny, nz = grid(cfg)
    return (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)


def make(cfg: dict, gen: torch.Generator, device, dtype=torch.float64):
    """``(indptr, indices, data)``: int32, int32 and ``dtype`` tensors."""
    nx, ny, nz = grid(cfg)
    n = nx * ny * nz
    r = torch.arange(n, device=device, dtype=torch.int64)
    ix, iy, iz = r % nx, (r // nx) % ny, r // (nx * ny)
    d = torch.tensor([-1, 0, 1], device=device, dtype=torch.int64)
    # the 27 offsets in HPCG's loop order (z, then y, then x): increasing
    dz, dy, dx = (t.reshape(-1) for t in torch.meshgrid(d, d, d,
                                                        indexing="ij"))
    inside = ((ix[:, None] + dx >= 0) & (ix[:, None] + dx < nx)
              & (iy[:, None] + dy >= 0) & (iy[:, None] + dy < ny)
              & (iz[:, None] + dz >= 0) & (iz[:, None] + dz < nz))
    cols = r[:, None] + (dz * ny + dy) * nx + dx
    diag = (dx == 0) & (dy == 0) & (dz == 0)
    vals = torch.where(diag, 26.0, -1.0).to(dtype).expand(n, SLOTS)
    cols = torch.where(inside, cols, r[:, None])
    vals = torch.where(inside, vals, torch.zeros((), dtype=dtype,
                                                 device=device))
    # the padded slots move beside the diagonal: columns stay in order
    cols, order = cols.sort(dim=1, stable=True)
    vals = vals.gather(1, order)
    indptr = torch.arange(n + 1, device=device, dtype=torch.int64) * SLOTS
    return (indptr.to(torch.int32), cols.reshape(-1).to(torch.int32),
            vals.reshape(-1).contiguous())
