"""Plain CG on a CSR operand, with the iteration structure of the
program's ``cg_sparse`` workload: ``iters`` unrolled iterations from
``x0``, no convergence test.  Returns ``(x_iters, r_iters)``."""
from __future__ import annotations

import torch

from bench.reference.csr import CSR


def solve(operand, b: torch.Tensor, x0: torch.Tensor, params: dict,
          dtype=torch.float64):
    indptr, indices, data = operand
    n = b.shape[0]
    A = CSR(indptr, indices, data, n, dtype)
    b, x = b.to(dtype), x0.to(dtype)
    r = b - A @ x
    p = r
    rs = torch.dot(r, r)
    for _ in range(int(params["iters"])):
        Ap = A @ p
        alpha = rs / torch.dot(p, Ap)
        x = alpha * p + x
        r = -alpha * Ap + r
        rs_new = torch.dot(r, r)
        p = (rs_new / rs) * p + r
        rs = rs_new
    return x, r
