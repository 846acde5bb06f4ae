"""The 5-point Laplacian of a g x g grid with Dirichlet boundaries, in CSR.

Row ``r = i * g + j`` holds ``4`` on the diagonal and ``-1`` for each grid
neighbour, its columns in increasing order (``r - g, r - 1, r, r + 1,
r + g`` where they exist), so ``nnz = 5n - 4g``.  The values do not depend
on the seed.  Built with whole-array torch operations on ``device``.
"""
from __future__ import annotations

import math

import torch


def grid_side(n: int) -> int:
    g = math.isqrt(n)
    if g * g != n:
        raise ValueError(f"laplacian5 needs a square grid: n={n}")
    return g


def make(cfg: dict, gen: torch.Generator, device, dtype=torch.float64):
    """``(indptr, indices, data)``: int32, int32 and ``dtype`` tensors."""
    n = int(cfg["params"]["n"])
    g = grid_side(n)
    r = torch.arange(n, device=device, dtype=torch.int64)
    i, j = r // g, r % g
    # the five candidate columns of every row, in increasing order
    cand = torch.stack([r - g, r - 1, r, r + 1, r + g], dim=1)
    keep = torch.stack([i > 0, j > 0, torch.ones_like(i, dtype=torch.bool),
                        j < g - 1, i < g - 1], dim=1)
    indices = cand[keep]
    data = torch.where(cand == r[:, None], 4.0, -1.0).to(dtype)[keep]
    indptr = torch.zeros(n + 1, device=device, dtype=torch.int64)
    indptr[1:] = torch.cumsum(keep.sum(dim=1), dim=0)
    return (indptr.to(torch.int32), indices.to(torch.int32),
            data.contiguous())


def served(cfg: dict, device, dtype=torch.float64):
    """The operator a served bucket holds: the program's router builds it
    by the same rule, whose values do not depend on a seed."""
    return make(cfg, None, device, dtype)
