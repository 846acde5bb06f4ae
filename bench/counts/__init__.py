"""The yardstick: the least bytes and operations a configuration's work
needs, worked out from its shapes alone, and the H100's data-sheet peaks
(``peaks.json``).  The counts are the same whatever implementation runs
the work, so a share of them cannot pass 100% unless the time leaves out
work.

Bytes are counted once for each input read and each output written:

* one CSR product ``y = A x`` (a B2 launch): the CSR triple (``indptr``
  and ``indices`` int32, ``data`` in the value type; every stored entry,
  an explicit zero too), ``x`` read and ``y`` written, each lane's ``x``
  and ``y`` in a lane form;
* a CG iteration: the operand once and the state vectors ``x``, ``r``
  and ``p`` each read and written once; a solve is ``iters + 1`` such
  passes (the initial residual reads the operand too);
* a BiCGStab iteration: two products (its two products are separated by
  dot products, so the operand is read twice); a solve is ``2 iters + 1``
  products, each charged the operand and its own ``x`` and ``y``.

A served request is charged its own vectors and ``1 / batch`` of the
operand's bytes, ``batch`` being the lanes that share one read of it.
"""
from __future__ import annotations

import json
import pathlib

PEAKS = json.loads((pathlib.Path(__file__).with_name("peaks.json"))
                   .read_text())

VALUE_BYTES = {"float64": 8, "float32": 4}
INDEX_BYTES = 4


def nnz(cfg: dict) -> int:
    """Entries a configuration's operand stores, each of which a product
    reads, from its operand's rule: the 5-point Laplacian's nonzeros;
    HPCG's operator at 27 slots a row, its padding included."""
    n = int(cfg["params"]["n"])
    operand = cfg["operand"]
    if operand == "laplacian5":
        g = int(round(n ** 0.5))
        if g * g != n:
            raise ValueError(f"laplacian5 needs a square grid: n={n}")
        return 5 * n - 4 * g
    if operand == "hpcg27":
        return 27 * n
    raise ValueError(f"no count for operand {operand!r}")


def operand_bytes(cfg: dict) -> int:
    n, vb = int(cfg["params"]["n"]), VALUE_BYTES[cfg["dtype"]]
    return (n + 1) * INDEX_BYTES + nnz(cfg) * (INDEX_BYTES + vb)


def vector_bytes(cfg: dict) -> int:
    return int(cfg["params"]["n"]) * VALUE_BYTES[cfg["dtype"]]


def spmv(cfg: dict, lanes: float = 1) -> dict:
    """One CSR product over ``lanes`` right-hand sides: bytes and flops."""
    return {"bytes": operand_bytes(cfg) + lanes * 2 * vector_bytes(cfg),
            "flops": 2 * nnz(cfg) * lanes}


def solve(cfg: dict, operand_share: float = 1.0) -> dict:
    """One solve of the configuration's workload: its products, bytes and
    flops, the operand charged ``operand_share`` of its bytes."""
    wl, iters = cfg["workload"], int(cfg["params"]["iters"])
    n, vec, op = int(cfg["params"]["n"]), vector_bytes(cfg), \
        operand_bytes(cfg) * operand_share
    if wl == "cg_sparse":
        passes = iters + 1
        # a product, two dots and three axpys an iteration (2 flops each)
        return {"spmvs": passes, "bytes": passes * (op + 6 * vec),
                "flops": passes * (2 * nnz(cfg) + 10 * n)}
    if wl == "bicgstab_sparse":
        passes = 2 * iters + 1
        return {"spmvs": passes, "bytes": passes * (op + 2 * vec),
                "flops": passes * 2 * nnz(cfg)}
    raise ValueError(f"no count for workload {wl!r}")


def least_seconds(work: dict, dtype: str) -> float:
    """The least time the chip needs: bytes at the HBM peak or flops at the
    vector peak of ``dtype``, whichever is longer."""
    return max(work["bytes"] / PEAKS["hbm_bytes_per_s"],
               work["flops"] / PEAKS["flops_per_s"][dtype])
