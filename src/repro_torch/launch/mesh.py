"""The device meshes: the LLM mesh (``make_local_mesh``,
``make_production_mesh``) and the solver mesh that a partitioned plan's
shards run on (``make_solver_mesh``).

The LLM mesh is the counterpart of ``repro/launch/mesh.py:9-26``: a
:class:`DeviceMesh` of ``data`` × ``model`` (and ``pod``) device slots,
with the axis names and shape of the JAX ``Mesh``.  One process drives
every slot, as below; ``launch.shardings`` places each leaf's shard on
its slot and ``models.sharded`` walks the slots.

The rest of this docstring is the solver mesh's.

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

from typing import Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["DeviceMesh", "NamedSharding", "PartitionSpec", "SolverMesh", "make_local_mesh",
           "make_production_mesh", "make_solver_mesh"]


def _concrete(device) -> torch.device:
    """``device`` with its index: ``cuda`` names the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class PartitionSpec(tuple):
    """The port's ``jax.sharding.PartitionSpec``: one entry a dimension,
    each ``None`` (not split), a mesh axis name, or a tuple of names (the
    dimension split over those axes together, row-major; a tuple of one
    name is that name, as JAX normalizes it).  Trailing dimensions without
    an entry are not split."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (list, tuple)):
                e = tuple(e)
                return e[0] if len(e) == 1 else (e or None)
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class NamedSharding:
    """The port's ``jax.sharding.NamedSharding``: ``spec`` over ``mesh``.
    :meth:`block` is the slice of a global tensor that a slot holds."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: "DeviceMesh", spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else \
            PartitionSpec(*spec)

    def split_dims(self):
        """(dimension, axes) for every split dimension."""
        return [(i, ax) for i, ax in enumerate(self.spec) if ax is not None]

    def shard_shape(self, shape) -> Tuple[int, ...]:
        out = list(shape)
        for i, ax in self.split_dims():
            n = self.mesh.axis_size(ax)
            if out[i] % n:
                raise ValueError(f"dimension {i} of {tuple(shape)} does not "
                                 f"split over {ax!r} ({n} slots)")
            out[i] //= n
        return tuple(out)

    def block(self, slot: int, shape) -> Tuple[slice, ...]:
        """The index of slot ``slot``'s shard in a global tensor of
        ``shape``."""
        local = self.shard_shape(shape)
        idx = [slice(None)] * len(shape)
        for i, ax in self.split_dims():
            j = self.mesh.index(slot, ax)
            idx[i] = slice(j * local[i], (j + 1) * local[i])
        return tuple(idx)

    def axes(self) -> Tuple[str, ...]:
        """The mesh axes the spec names."""
        out = []
        for _, ax in self.split_dims():
            out += [ax] if isinstance(ax, str) else list(ax)
        return tuple(out)

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and self.mesh == other.mesh
                and self.spec == other.spec)

    def __hash__(self) -> int:
        return hash((self.mesh, self.spec))

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


#: the kinds of exchange a :class:`DeviceMesh` counts
EXCHANGES = ("psum", "pmax", "all_gather", "ppermute", "gather")


def _named_devices(device) -> torch.device:
    """``device`` as the LLM mesh's slots take it: ``None`` is the current
    card, ``"meta"`` builds a mesh that holds no memory."""
    return _concrete("cuda" if device is None else device)


class DeviceMesh:
    """An N-D mesh of device slots under ``axis_names`` (the JAX
    ``Mesh``'s counterpart for the LLM stack).

    ``shape`` maps each axis name to its extent, in axis order, as
    ``Mesh.shape`` does; ``devices`` holds one device per slot, slots
    numbered row-major over the axes (the last axis fastest).  On one
    card, or on the CPU, every slot names the same device: each slot
    still holds its own tensors, and every exchange between slots is an
    explicit copy or sum (``models.sharded``).

    ``exchanged`` counts the bytes that the exchanges moved between
    slots, by kind: ``psum`` and ``pmax`` (a fold to the group's first
    slot and a copy back, ``2·(n−1)·b`` for n parts of b bytes; both are
    the reference's all-reduce, with ``add`` and ``max``),
    ``all_gather`` (every slot receives the n−1 parts it does not hold,
    ``n·(n−1)·b``), ``ppermute`` (every slot of a group receives one
    part, ``n·b``) and ``gather`` (parts put together on slot 0, the
    bytes of every part held elsewhere); ``n_<kind>`` counts the
    exchanges of each kind, one a call that moves bytes, whatever its
    groups.  :meth:`reset_exchanged` zeroes them."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Sequence):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} for axes "
                             f"{tuple(axis_names)}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))
        n = 1
        for e in self.shape.values():
            n *= e
        if len(devices) != n:
            raise ValueError(f"{len(devices)} devices for {n} slots")
        self.devices: Tuple[torch.device, ...] = tuple(
            _concrete(d) for d in devices)
        self.exchanged = dict.fromkeys(
            EXCHANGES + tuple(f"n_{k}" for k in EXCHANGES), 0)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """The data-parallel axes: ("pod", "data") where present."""
        return tuple(n for n in ("pod", "data") if n in self.shape)

    def axis_size(self, axes) -> int:
        """The slots along ``axes``: an axis name, a tuple of them, or
        None (1)."""
        if axes is None:
            return 1
        if isinstance(axes, str):
            return self.shape[axes]
        n = 1
        for a in axes:
            n *= self.shape[a]
        return n

    def coords(self, slot: int) -> Dict[str, int]:
        """The slot's index along every axis."""
        out = {}
        for name in reversed(self.axis_names):
            slot, out[name] = divmod(slot, self.shape[name])
        return {name: out[name] for name in self.axis_names}

    def index(self, slot: int, axes) -> int:
        """The slot's index along ``axes`` taken together (row-major)."""
        if axes is None:
            return 0
        if isinstance(axes, str):
            axes = (axes,)
        c = self.coords(slot)
        i = 0
        for a in axes:
            i = i * self.shape[a] + c[a]
        return i

    def groups(self, axes: Sequence[str], span: Optional[int] = None
               ) -> List[List[int]]:
        """The slots in groups that differ only along ``axes`` (names not
        in the mesh are ignored), each group in order along ``axes``;
        with ``span``, each group cut into runs of ``span`` consecutive
        slots (XLA's replica groups of ``[n/span, span]``)."""
        axes = tuple(a for a in axes if a in self.shape)
        keyed: Dict[Tuple, List[int]] = {}
        for k in range(self.size):
            c = self.coords(k)
            key = tuple(c[a] for a in self.axis_names if a not in axes)
            keyed.setdefault(key, []).append(k)
        for members in keyed.values():
            members.sort(key=lambda k: self.index(k, axes))
        if span is None:
            return list(keyed.values())
        return [members[i:i + span] for members in keyed.values()
                for i in range(0, len(members), span)]

    def reset_exchanged(self) -> None:
        for k in self.exchanged:
            self.exchanged[k] = 0

    def record(self, kind: str, nbytes: int) -> None:
        """One exchange of ``kind`` that moved ``nbytes`` between slots (a
        call that moved nothing, over groups of one slot, is none)."""
        if nbytes:
            self.exchanged[kind] += nbytes
            self.exchanged[f"n_{kind}"] += 1

    def psum(self, parts: Sequence[torch.Tensor], axes: Sequence[str],
             dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
        """For every group along ``axes``: ``((p0 + p1) + p2) + …`` in
        group order on its first slot, in ``dtype`` (the parts' own when
        None), then a copy of the total on every other slot of the group.
        Differentiable: each part's gradient is the sum of the copies'."""
        if len(parts) != self.size:
            raise ValueError(f"psum: {len(parts)} parts for {self.size} "
                             "slots")
        out: List[Optional[torch.Tensor]] = [None] * self.size
        moved = 0
        for members in self.groups(axes):
            first = members[0]
            total = parts[first]
            if dtype is not None:
                total = total.to(dtype)
            for k in members[1:]:
                total = total + parts[k].to(self.devices[first], dtype)
            out[first] = total
            for k in members[1:]:
                out[k] = total.to(self.devices[k], copy=True)
            moved += 2 * (len(members) - 1) * (
                total.numel() * total.element_size())
        self.record("psum", moved)
        return out

    @torch.no_grad()
    def psum_(self, parts: Sequence[torch.Tensor], axes: Sequence[str]
              ) -> Sequence[torch.Tensor]:
        """:meth:`psum` written into the parts themselves (the group's
        first part takes the sum, in the same order, the others a copy of
        it); not differentiable, and it holds no second copy."""
        if len(parts) != self.size:
            raise ValueError(f"psum_: {len(parts)} parts for {self.size} "
                             "slots")
        moved = 0
        for members in self.groups(axes):
            total = parts[members[0]]
            for k in members[1:]:
                total.add_(parts[k].to(total.device))
            for k in members[1:]:
                parts[k].copy_(total)
            moved += 2 * (len(members) - 1) * (
                total.numel() * total.element_size())
        self.record("psum", moved)
        return parts

    @torch.no_grad()
    def pmax(self, parts: Sequence[torch.Tensor], axes: Sequence[str]
             ) -> List[torch.Tensor]:
        """For every group along ``axes``: the parts' elementwise maximum,
        folded in group order on its first slot, then a copy on every other
        slot of the group (an all-reduce with ``max``).  Not
        differentiable: it takes the shift of a softmax, whose gradient
        does not depend on it."""
        if len(parts) != self.size:
            raise ValueError(f"pmax: {len(parts)} parts for {self.size} "
                             "slots")
        out: List[Optional[torch.Tensor]] = [None] * self.size
        moved = 0
        for members in self.groups(axes):
            first = members[0]
            total = parts[first]
            for k in members[1:]:
                total = torch.maximum(total, parts[k].to(self.devices[first]))
            out[first] = total
            for k in members[1:]:
                out[k] = total.to(self.devices[k], copy=True)
            moved += 2 * (len(members) - 1) * (
                total.numel() * total.element_size())
        self.record("pmax", moved)
        return out

    def all_gather(self, parts: Sequence[torch.Tensor], axes: Sequence[str],
                   dim: int, span: Optional[int] = None
                   ) -> List[torch.Tensor]:
        """For every group along ``axes`` (runs of ``span`` slots of it,
        where given): its parts concatenated along ``dim`` in group order,
        one whole tensor on each slot of the group.  Differentiable."""
        out: List[Optional[torch.Tensor]] = [None] * self.size
        moved = 0
        for members in self.groups(axes, span):
            n = len(members)
            for k in members:
                out[k] = (torch.cat([parts[j].to(self.devices[k])
                                     for j in members], dim) if n > 1
                          else parts[k])
            part = parts[members[0]]
            moved += n * (n - 1) * part.numel() * part.element_size()
        self.record("all_gather", moved)
        return out

    def ppermute(self, parts: Sequence[torch.Tensor], axes: Sequence[str],
                 shift: int) -> List[torch.Tensor]:
        """For every group along ``axes``: the slot at position ``(j +
        shift) % n`` of the group receives the part of position ``j``
        (``lax.ppermute`` on a ring).  Differentiable."""
        out: List[Optional[torch.Tensor]] = [None] * self.size
        moved = 0
        for members in self.groups(axes):
            n = len(members)
            for j, k in enumerate(members):
                dst = members[(j + shift) % n]
                out[dst] = parts[k].to(self.devices[dst], copy=True)
                moved += parts[k].numel() * parts[k].element_size()
        self.record("ppermute", moved)
        return out

    def gather(self, parts: Sequence[torch.Tensor], slots: Sequence[int],
               dim: int) -> torch.Tensor:
        """``parts[k]`` for ``k`` in ``slots``, concatenated along ``dim``
        on slot 0.  Differentiable."""
        dev = self.devices[0]
        self.record("gather", sum(parts[k].numel() * parts[k].element_size()
                                  for k in slots if k != 0))
        if len(slots) == 1:
            return parts[slots[0]].to(dev)
        return torch.cat([parts[k].to(dev) for k in slots], dim)

    def __eq__(self, other) -> bool:
        return (isinstance(other, DeviceMesh)
                and self.axis_names == other.axis_names
                and self.shape == other.shape
                and self.devices == other.devices)

    def __hash__(self) -> int:
        return hash((self.axis_names, tuple(self.shape.values()),
                     self.devices))

    def __repr__(self) -> str:
        distinct = list(dict.fromkeys(str(d) for d in self.devices))
        axes = ", ".join(f"{a!r}: {n}" for a, n in self.shape.items())
        return f"DeviceMesh({axes}; {', '.join(distinct)})"


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[object] = None) -> DeviceMesh:
    """Production mesh: 16×16 = 256 slots per pod; 2 pods when
    ``multi_pod``.  Axes ("data", "model") single-pod, ("pod", "data",
    "model") multi-pod; DP runs over ("pod", "data"), TP/EP over "model"
    (``repro/launch/mesh.py:9-16``).

    One slot a device: on a real device it raises where fewer devices
    exist than slots (the JAX one raises so on one CPU), so on the CPU
    and on one card it always raises.  ``device="meta"`` builds it on
    the meta device (no memory), as the dry-run lowers against."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for e in shape:
        n *= e
    dev = _named_devices(device)
    if dev.type == "meta":
        return DeviceMesh(shape, axes, [dev] * n)
    have = torch.cuda.device_count() if dev.type == "cuda" else 1
    if have < n:
        raise ValueError(f"need {n} devices, have {have}")
    return DeviceMesh(shape, axes, [torch.device(dev.type, i)
                                    for i in range(n)])


def make_local_mesh(data: int = 1, model: int = 1, *,
                    device: Optional[object] = None) -> DeviceMesh:
    """A ("data", "model") mesh of ``data × model`` slots, every slot on
    ``device`` (``None``: the current card) — the single-controller form
    of ``repro/launch/mesh.py:19-26`` on one device."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh extents must be >= 1, got ({data}, "
                         f"{model})")
    dev = _named_devices(device)
    return DeviceMesh((data, model), ("data", "model"),
                      [dev] * (data * model))


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
