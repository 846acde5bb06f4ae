"""Plain BiCGStab on a CSR operand, with the iteration structure of the
program's ``bicgstab_sparse`` workload: ``iters`` unrolled iterations from
``x0`` (two products a step), the shadow residual fixed at ``r0``, no
convergence test.  Returns ``(x_iters, r_iters)``."""
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
    rhat = r
    p = r
    rho = torch.dot(rhat, r)
    for _ in range(int(params["iters"])):
        v = A @ p
        alpha = rho / torch.dot(rhat, v)
        s = -alpha * v + r
        t = A @ s
        omega = torch.dot(t, s) / torch.dot(t, t)
        x = omega * s + (alpha * p + x)
        r = -omega * t + s
        rho_new = torch.dot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = beta * (-omega * v + p) + r
        rho = rho_new
    return x, r
