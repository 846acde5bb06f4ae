"""The operand generators against their rules at small sizes."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bench.harness.spec import Spec


def dense(indptr, indices, data, n):
    a = np.zeros((n, n))
    ip = indptr.numpy()
    for r in range(n):
        for e in range(ip[r], ip[r + 1]):
            a[r, indices[e]] += float(data[e])
    return a


def test_laplacian5_is_the_dense_5_point_stencil():
    g = 5
    n = g * g
    mod = Spec().operands("laplacian5")
    indptr, indices, data = mod.make(cfg(n), torch.Generator(), "cpu")
    want = np.zeros((n, n))
    for i in range(g):
        for j in range(g):
            r = i * g + j
            want[r, r] = 4.0
            for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                if 0 <= i + di < g and 0 <= j + dj < g:
                    want[r, (i + di) * g + j + dj] = -1.0
    assert indptr.dtype == indices.dtype == torch.int32
    assert data.dtype == torch.float64
    assert int(indptr[-1]) == 5 * n - 4 * g
    np.testing.assert_array_equal(dense(indptr, indices, data, n), want)
    for r in range(n):        # columns in increasing order within a row
        cols = indices[indptr[r]:indptr[r + 1]]
        assert bool((cols[1:] > cols[:-1]).all())


def test_laplacian5_needs_a_square_grid():
    with pytest.raises(ValueError):
        Spec().operands("laplacian5").make(cfg(10), torch.Generator(),
                                           "cpu")


def cfg(n, grid=None):
    return {"params": {"n": n}, "grid": grid}


def hpcg27(grid):
    n = grid[0] * grid[1] * grid[2]
    return n, Spec().operands("hpcg27").make(cfg(n, grid), torch.Generator(),
                                             "cpu")


@pytest.mark.parametrize("grid", [(4, 3, 5), (3, 3, 3), (1, 4, 2)])
def test_hpcg27_is_the_dense_27_point_stencil(grid):
    nx, ny, nz = grid
    n, (indptr, indices, data) = hpcg27(list(grid))
    want = np.zeros((n, n))
    for iz in range(nz):
        for iy in range(ny):
            for ix in range(nx):
                r = (iz * ny + iy) * nx + ix
                for dz in (-1, 0, 1):
                    for dy in (-1, 0, 1):
                        for dx in (-1, 0, 1):
                            z, y, x = iz + dz, iy + dy, ix + dx
                            if 0 <= z < nz and 0 <= y < ny and 0 <= x < nx:
                                c = (z * ny + y) * nx + x
                                want[r, c] = 26.0 if c == r else -1.0
    assert indptr.dtype == indices.dtype == torch.int32
    assert data.dtype == torch.float64
    assert torch.equal(indptr, torch.arange(n + 1, dtype=torch.int32) * 27)
    np.testing.assert_array_equal(dense(indptr, indices, data, n), want)
    mod = Spec().operands("hpcg27")
    assert int((data != 0).sum()) == mod.nonzeros(cfg(n, grid)) == \
        int((want != 0).sum())
    for r in range(n):        # columns in order; padding at the diagonal
        cols = indices[27 * r:27 * (r + 1)]
        vals = data[27 * r:27 * (r + 1)]
        assert bool((cols[1:] >= cols[:-1]).all())
        assert bool((cols[vals == 0] == r).all())


def test_hpcg27_at_the_published_grid_counts():
    mod = Spec().operands("hpcg27")
    assert mod.nonzeros(cfg(104 ** 3, [104] * 3)) == 29_791_000
    with pytest.raises(ValueError):
        mod.grid(cfg(104 ** 3 + 1, [104] * 3))


def test_served_operand_is_the_one_the_router_builds():
    """A served bucket's operator, rebuilt by the rule without the program,
    equals the program's own (its feeds at the router's seed 0)."""
    from repro_torch.frontends import sparse
    n = 12 * 12
    got = Spec().operands("laplacian5").served(cfg(n), "cpu")
    want = sparse._components("laplacian5", n, None, None, 0, "A")
    for g, role in zip(got, ("indptr", "indices", "data")):
        np.testing.assert_array_equal(g.numpy(), want[role])
