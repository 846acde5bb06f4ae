"""The comparison that decides ``correct``.

Each sampled answer of the timed path, ``(x, r)``, is held against the
plain reference's ``(x_ref, r_ref)`` for the same operand, right-hand side
and start, computed in the precision the configuration states:

* ``gap_x``: ``max |x - x_ref| / max |x_ref|``, the solution's worst
  entry against the solution's scale;
* ``gap_r``: ``max |r - r_ref| / max |b|``, the residual's worst entry
  against the right-hand side's scale (a converged residual is itself
  rounding, so its own scale would judge noise).

A cell's numbers are the worst over its sample.  An answer that holds a
NaN or an infinity reads infinite.  Each number has its limit
(``limits/<cell>.json``), set between the program's readings over many
seeds and the reading of the control, the reference in the next precision
down; ``correct`` holds when no answer failed and every number is at or
under its limit.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import torch

NUMBERS = ("gap_x", "gap_r")


def _worst_rel(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor
               ) -> float:
    d = (a.to(torch.float64) - b.to(torch.float64)).abs().max()
    s = scale.to(torch.float64).abs().max()
    val = float(d / s)
    return val if math.isfinite(val) else math.inf


def gaps(x, r, x_ref, r_ref, b) -> Dict[str, float]:
    return {"gap_x": _worst_rel(x, x_ref, x_ref),
            "gap_r": _worst_rel(r, r_ref, b)}


def worst(readings: Iterable[Dict[str, float]]) -> Dict[str, float]:
    out = dict.fromkeys(NUMBERS, 0.0)
    n = 0
    for rd in readings:
        n += 1
        for k in NUMBERS:
            out[k] = max(out[k], rd[k])
    if n == 0:
        return dict.fromkeys(NUMBERS, math.inf)
    return out


def decide(numbers: Dict[str, float], limits: Dict[str, float],
           failed: int) -> Tuple[bool, List[str]]:
    """``correct``, and one line a number: its value beside its limit."""
    lines = [f"{k} {numbers[k]!r} limit {limits[k]!r}" for k in NUMBERS]
    ok = failed == 0 and all(numbers[k] <= limits[k] for k in NUMBERS)
    return ok, lines
