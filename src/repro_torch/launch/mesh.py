"""The solver mesh: K device slots that a partitioned plan's shards run on.

The counterpart of ``repro.launch.mesh.make_solver_mesh``
(``repro/launch/mesh.py:42-56``).  The JAX package drives its mesh from one
controller: one process runs K devices through ``jax.jit(shard_map(...))``,
and its own tests run K forced host devices on one CPU.  The port keeps
that design: one process drives K device slots.  The machine with the card
has one GPU (NCCL takes no two ranks on one), so on the CPU and on one
card all K slots sit on the one device, as the JAX suite's forced host
devices share one CPU.

Each shard's tensors are separate tensors, and every exchange between
shards is an explicit copy or reduction, in shard order, over per-shard
lists:

* :meth:`SolverMesh.split` — a global tensor's row blocks, one a slot
  (``shard_map``'s ``in_specs=P(axis)``);
* :meth:`SolverMesh.all_gather` — the blocks concatenated into one whole
  tensor per slot (``lax.all_gather(..., tiled=True)``);
* :meth:`SolverMesh.psum` — a left fold over shards 0..K-1, the total on
  every slot (``lax.psum``);
* :meth:`SolverMesh.ppermute` — one boundary row to the previous or next
  shard, circular (``lax.ppermute``);
* :meth:`SolverMesh.concat` — the blocks as one global tensor on slot 0
  (``out_specs=P(axis)``).

A block moves between slots with ``Tensor.to``: a copy when the slots'
devices differ, none when they are the same device.  A mesh over several
cards (slots on distinct devices) needs no other change here.

There is no ``shard_map_compat`` counterpart: the shards' bodies are not
traced, the sharded program walks them.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

__all__ = ["SolverMesh", "make_solver_mesh"]


def _concrete(device) -> torch.device:
    """``device`` with its index: ``cuda`` names the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class SolverMesh:
    """A 1-D mesh of device slots under one axis name (see the module
    docstring)."""

    def __init__(self, devices: Sequence, axis: str = "shards"):
        if not devices:
            raise ValueError("a solver mesh needs at least one device slot")
        self.devices: Tuple[torch.device, ...] = tuple(
            _concrete(d) for d in devices)
        self.axis = axis

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    def describe(self) -> str:
        """``4 shards over 1 device (cuda:0)``."""
        distinct = list(dict.fromkeys(str(d) for d in self.devices))
        return (f"{self.n_shards} shard{'s' * (self.n_shards != 1)} over "
                f"{len(distinct)} device{'s' * (len(distinct) != 1)} "
                f"({', '.join(distinct)})")

    def _check(self, parts: Sequence[torch.Tensor], what: str) -> None:
        if len(parts) != self.n_shards:
            raise ValueError(f"{what}: {len(parts)} parts for "
                             f"{self.n_shards} shards")

    def split(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Row block ``k`` of ``t`` on slot ``k``, for every ``k``."""
        rows = t.shape[0]
        if rows % self.n_shards:
            raise ValueError(f"{rows} rows do not split evenly over "
                             f"{self.n_shards} shards")
        rl = rows // self.n_shards
        return [t[k * rl:(k + 1) * rl].to(dev)
                for k, dev in enumerate(self.devices)]

    def all_gather(self, blocks: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """The blocks concatenated in shard order, one whole tensor per
        slot."""
        self._check(blocks, "all_gather")
        return [torch.cat([b.to(dev) for b in blocks])
                for dev in self.devices]

    def psum(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``((p0 + p1) + p2) + …`` on slot 0, then a copy of the total on
        every other slot."""
        self._check(parts, "psum")
        total = parts[0]
        for p in parts[1:]:
            total = total + p.to(self.devices[0])
        return [total] + [total.to(dev, copy=True)
                          for dev in self.devices[1:]]

    def ppermute(self, rows: Sequence[torch.Tensor], shift: int
                 ) -> List[torch.Tensor]:
        """Slot ``(k + shift) % K`` receives ``rows[k]``: ``shift=1`` sends
        each shard's row to the next shard, ``-1`` to the previous."""
        self._check(rows, "ppermute")
        k_ = self.n_shards
        return [rows[(j - shift) % k_].to(self.devices[j], copy=True)
                for j in range(k_)]

    def concat(self, blocks: Sequence[torch.Tensor]) -> torch.Tensor:
        """The blocks in shard order as one tensor on slot 0."""
        self._check(blocks, "concat")
        return torch.cat([b.to(self.devices[0]) for b in blocks])

    def __repr__(self) -> str:
        return f"SolverMesh({self.axis!r}: {self.describe()})"


def make_solver_mesh(n_shards: int, *, axis: str = "shards",
                     device: Optional[object] = None) -> SolverMesh:
    """A 1-D mesh of ``n_shards`` slots for row-block sharded solver plans
    (``core.lowering.partition_plan``), every slot on ``device``
    (``None``: the current card)."""
    if n_shards < 1:
        raise ValueError(f"shard count must be >= 1, got {n_shards}")
    dev = "cuda" if device is None else device
    return SolverMesh([dev] * int(n_shards), axis=axis)
