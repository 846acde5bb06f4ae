"""Roofline accounting for the dry run: the counterpart of
``repro.launch.roofline``.

The per-chip peaks sit in one table of two rows (:class:`Chip`):

* ``H100`` — what the port uses: the NVIDIA H100 SXM5 80GB HBM3 at 700 W,
  data-sheet numbers (989 TFLOP/s dense bf16 on the tensor cores, 495
  TF32, 67 fp32 and 34 fp64 on the CUDA cores; 3.35 TB/s of HBM3).  The
  link is charged as the reference charges one: a single link a
  direction.  The production mesh's "model" axis is 16 wide, so it spans
  two 8-GPU HGX nodes, and its rings cross the InfiniBand NDR link of
  each GPU, 50 GB/s a direction (NVLink 4, inside one node, gives 450
  GB/s a direction: the conservative charge is the slower link);
* ``V5E`` — the JAX package's constants (197 TFLOP/s bf16, 819 GB/s HBM,
  50 GB/s a link), kept so that the tests can hold this module to the
  reference.  No number of the port is computed with them.

Conventions, as in the reference: the flops and bytes are per chip
(the dry run's totals over the mesh's slots divided by the slots, which
equals global / (chips × peak) for balanced shards), and every term
divides by a per-chip peak.  Collective traffic is the ring algorithm's
bytes per chip:

    all-gather       (N-1)/N × result
    all-reduce       2 (N-1)/N × result
    reduce-scatter   (N-1) × result        (operand = N × result)
    all-to-all       (N-1)/N × result
    collective-permute   1 × result

The reference parses them from XLA's optimized HLO text
(``parse_collectives``).  The port has no HLO: :func:`collectives` reads
them from the mesh's exchange counter (``DeviceMesh.exchanged``), whose
charges are these (see its docstring).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

from ..configs.base import ArchConfig, ShapeSpec

__all__ = ["Chip", "H100", "V5E", "RooflineTerms", "collectives",
           "model_flops", "roofline"]


@dataclasses.dataclass(frozen=True)
class Chip:
    """One chip's peaks: ``flops`` the dense rate of each type (operations
    a second; ``"bfloat16"`` is the roofline's compute peak), ``hbm_bw``
    and ``link_bw`` in bytes a second."""
    name: str
    flops: Mapping[str, float]
    hbm_bw: float
    link_bw: float


#: NVIDIA H100 SXM5 80GB HBM3 at 700 W, data sheet: dense tensor-core
#: bf16 and TF32, CUDA-core fp32 and fp64, HBM3; the link is InfiniBand
#: NDR's 50 GB/s a GPU and direction (NVLink 4: 450 GB/s a direction)
H100 = Chip("H100 SXM5 80GB HBM3, 700 W (data sheet)",
            {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12,
             "float64": 34e12}, 3.35e12, 50e9)
#: the JAX package's TPU v5e constants (``repro/launch/roofline.py``),
#: for the parity tests only
V5E = Chip("TPU v5e (the JAX package's constants)", {"bfloat16": 197e12},
           819e9, 50e9)


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (prefill/decode), N active."""
    n = cfg.active_params() if cfg.is_moe else cfg.total_params()
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch          # decode: one token per seq


#: the reference's collective kinds, by the mesh exchanges that are one
_KINDS = {"all-gather": ("all_gather",), "all-reduce": ("psum", "pmax"),
          "reduce-scatter": (), "all-to-all": (),
          "collective-permute": ("ppermute",)}


def collectives(mesh) -> Dict[str, float]:
    """Per-chip collective bytes by kind (+ ``total``, + ``n_<kind>``),
    the reference's ``parse_collectives`` keys, from ``mesh.exchanged``.

    ``DeviceMesh.psum`` and ``pmax`` (the all-reduce with ``add`` and
    with ``max``) record 2·(n−1)·b a group of n parts of b bytes,
    ``all_gather`` n·(n−1)·b (b a part: the result is n·b) and
    ``ppermute`` n·b; where the groups cover every slot, the sum over the
    groups divided by the slots is the reference's 2(n−1)/n × result,
    (n−1)/n × result and 1 × result per chip.  The port has no
    reduce-scatter or all-to-all: those stay 0.

    ``gather`` (parts put together on slot 0: the mesh walk's global
    logits in serving and its prefill caches) is none of the five kinds,
    since the reference's cells keep those outputs sharded.  It stands
    beside them as ``gather`` / ``n_gather``, outside ``total``: the
    bytes slot 0 receives, all of them, since one chip's link carries
    them.  A train step gathers nothing: its loss is vocab-parallel."""
    x = mesh.exchanged
    out: Dict[str, float] = {}
    for kind, ours in _KINDS.items():
        out[kind] = sum(x[k] for k in ours) / mesh.size
    out["total"] = sum(out[k] for k in _KINDS)
    for kind, ours in _KINDS.items():
        out[f"n_{kind}"] = sum(x[f"n_{k}"] for k in ours)
    out["gather"] = float(x["gather"])
    out["n_gather"] = x["n_gather"]
    return out


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    n_chips: int
    model_flops_total: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        counted = self.flops_per_chip * self.n_chips
        return self.model_flops_total / counted if counted else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the dominant term
        were the wall clock: compute_s / bound_s."""
        return self.compute_s / self.bound_s if self.bound_s else 0.0

    def to_dict(self) -> Dict:
        return {**dataclasses.asdict(self), "dominant": self.dominant,
                "bound_s": self.bound_s,
                "useful_flops_ratio": self.useful_flops_ratio,
                "roofline_fraction": self.roofline_fraction}


def roofline(flops_per_chip: float, bytes_per_chip: float,
             coll_bytes_per_chip: float, n_chips: int,
             model_flops_total: float, hw: Chip = H100) -> RooflineTerms:
    """The three terms on ``hw``'s peaks (its bf16 rate for the compute
    term)."""
    return RooflineTerms(
        compute_s=flops_per_chip / hw.flops["bfloat16"],
        memory_s=bytes_per_chip / hw.hbm_bw,
        collective_s=coll_bytes_per_chip / hw.link_bw,
        flops_per_chip=flops_per_chip,
        bytes_per_chip=bytes_per_chip,
        coll_bytes_per_chip=coll_bytes_per_chip,
        n_chips=n_chips,
        model_flops_total=model_flops_total)
