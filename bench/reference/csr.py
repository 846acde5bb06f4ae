"""The plain reference's sparse matrix-vector product: a CSR operand as a
``torch.sparse_csr_tensor`` and ``A @ x`` through PyTorch's own sparse
product.  Nothing here imports the program under test."""
from __future__ import annotations

import warnings

import torch


class CSR:
    """A square CSR operand in one float dtype.  Stored zeros (a padded
    layout's free slots) are dropped: they add nothing to a product, and
    what stays has each row's columns distinct."""

    def __init__(self, indptr, indices, data, n: int, dtype):
        self.n = n
        indptr = indptr.to(torch.int64)
        keep = data != 0
        rows = torch.repeat_interleave(
            torch.arange(n, device=data.device), indptr.diff())[keep]
        indptr = torch.zeros(n + 1, dtype=torch.int64, device=data.device)
        indptr[1:] = torch.bincount(rows, minlength=n).cumsum(0)
        with warnings.catch_warnings():     # "sparse CSR is in beta"
            warnings.simplefilter("ignore", UserWarning)
            self.mat = torch.sparse_csr_tensor(
                indptr, indices[keep].to(torch.int64),
                data[keep].to(dtype), (n, n), check_invariants=False)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return (self.mat @ x[:, None])[:, 0]
