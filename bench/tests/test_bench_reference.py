"""The plain references against dense solves, and the control: the
reference one precision down, put in the program's place, comes out as not
correct by the cells' limits."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from bench.harness import judge
from bench.harness.spec import ROOT, Spec


def laplacian(g):
    return Spec().operands("laplacian5").make(
        {"params": {"n": g * g}}, torch.Generator(), "cpu")


def hpcg27(grid):
    n = grid[0] * grid[1] * grid[2]
    return Spec().operands("hpcg27").make(
        {"params": {"n": n}, "grid": grid}, torch.Generator(), "cpu")


def as_dense(op, n):
    indptr, indices, data = op
    a = np.zeros((n, n))
    rows = np.repeat(np.arange(n), np.diff(indptr.numpy()))
    np.add.at(a, (rows, indices.numpy()), data.numpy())
    return a


def test_cg_converges_to_the_dense_solve():
    g = 6
    n = g * g
    op = laplacian(g)
    b = torch.randn(n, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    x, r = Spec().reference("cg_sparse").solve(
        op, b, torch.zeros(n, dtype=torch.float64), {"iters": 60})
    want = np.linalg.solve(as_dense(op, n), b.numpy())
    np.testing.assert_allclose(x.numpy(), want, rtol=0, atol=1e-10)
    np.testing.assert_allclose(r.numpy(), b.numpy() - as_dense(op, n)
                               @ x.numpy(), atol=1e-10)


def test_bicgstab_converges_to_the_dense_solve():
    n = 120
    op = hpcg27([6, 5, 4])
    b = torch.randn(n, generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64)
    x, r = Spec().reference("bicgstab_sparse").solve(
        op, b, torch.zeros(n, dtype=torch.float64), {"iters": 24})
    a = as_dense(op, n)
    want = np.linalg.solve(a, b.numpy())
    np.testing.assert_allclose(x.numpy(), want, rtol=0, atol=1e-10)
    assert np.abs(b.numpy() - a @ x.numpy()).max() < 1e-9


def test_cg_follows_the_workload_iteration():
    """One unrolled CG step, written out, equals the reference's."""
    g = 4
    n = g * g
    op = laplacian(g)
    a = torch.from_numpy(as_dense(op, n))
    b = torch.randn(n, generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64)
    r = b.clone()
    p, rs = r, r @ r
    ap = a @ p
    alpha = rs / (p @ ap)
    x, r = alpha * p, r - alpha * ap
    got = Spec().reference("cg_sparse").solve(
        op, b, torch.zeros(n, dtype=torch.float64), {"iters": 1})
    torch.testing.assert_close(got[0], x, rtol=0, atol=1e-14)
    torch.testing.assert_close(got[1], r, rtol=0, atol=1e-14)


CONTROL_CASES = (("poisson2d_cg.solve", "cg_sparse", 64 * 64, {"iters": 64}),
                 ("hpcg27_bicgstab.solve", "bicgstab_sparse", 16 ** 3,
                  {"iters": 16, "grid": [16, 16, 16]}),
                 ("poisson2d_cg.serve", "cg_sparse", 64 * 64, {"iters": 64}))


@pytest.mark.parametrize("cell, workload, n, params", CONTROL_CASES)
def test_control_in_float32_is_not_correct(cell, workload, n, params):
    """The control at a size a test run holds: the reference in float32
    put in the program's place fails one of the cell's limits, on three
    seeds."""
    spec = Spec()
    limits = json.loads((ROOT / "bench" / "limits" / f"{cell}.json")
                        .read_text())["limits"]
    ref = spec.reference(workload)
    for seed in (1, 2, 3):
        op = (laplacian(int(n ** 0.5)) if workload == "cg_sparse"
              else hpcg27(params["grid"]))
        b = torch.randn(n, generator=torch.Generator().manual_seed(seed),
                        dtype=torch.float64)
        x0 = torch.zeros(n, dtype=torch.float64)
        x64, r64 = ref.solve(op, b, x0, params, torch.float64)
        x32, r32 = ref.solve(op, b, x0, params, torch.float32)
        numbers = judge.gaps(x32, r32, x64, r64, b)
        ok, _lines = judge.decide(numbers, limits, failed=0)
        assert not ok, numbers
