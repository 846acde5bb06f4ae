"""Lowering CELLO co-design decisions on an LLM layer graph to a plan.

The counterpart of ``repro.core.policy``, copied: the co-design result
(fusion groups + pins + buffer split) becomes

* **kernel selection** — a fusion group covering {scores, softmax, pv}
  turns on the flash-attention kernel (B5); one covering {up, act, down}
  turns on the fused-MLP kernel (B6).  Block shapes are derived from the
  explicit-region budget of the hardware model (``V5E`` by default, so
  that plans equal the JAX package's); the port's kernels choose their own
  tiles for the card and read only the flags;
* **remat policy** — tensors the co-designer kept on-chip become the
  names a training step saves (``remat_save_names``); everything else is
  recomputed in the backward pass.  ``checkpoint_policy()`` builds the
  policy object that ``launch.train`` checkpoints each layer with
  (``models.common.RematPolicy``: selective activation checkpointing on
  the models' ``tag`` names).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from ..configs.base import ArchConfig
from .costmodel import HardwareModel, V5E
from .schedule import CoDesignResult

# canonical checkpoint-name tags of the model zoo
KNOWN_SAVE_NAMES = ("attn_out", "mlp_out", "q_out", "kv_out", "probs",
                    "mlp_hidden", "router_logits", "rnn_state", "x_mid")


@dataclasses.dataclass(frozen=True)
class CelloPlan:
    arch: str
    use_flash_attention: bool = True
    q_block: int = 512
    kv_block: int = 512
    use_fused_mlp: bool = True
    mlp_block_m: int = 256
    mlp_block_f: int = 512
    use_fused_rmsnorm: bool = True
    remat_save_names: Tuple[str, ...] = ("attn_out", "mlp_out")
    explicit_frac: float = 0.5
    # decode-cache write strategy: broadcast-select (True) vs a slice
    # update (False)
    cache_select_update: bool = True
    # MoE expert-capacity factor
    moe_capacity_factor: float = 1.25
    notes: str = ""

    def checkpoint_policy(self):
        """A fresh :class:`~repro_torch.models.common.RematPolicy` that
        saves exactly ``remat_save_names`` (none: nothing saveable)."""
        from ..models.common import RematPolicy
        return RematPolicy(self.remat_save_names)


def _pick_attention_blocks(head_dim: int, explicit_bytes: int,
                           seq: int) -> Tuple[int, int]:
    """Largest MXU-aligned (q_block, kv_block) whose flash working set fits.

    Working set per (q_blk, kv_blk) tile, bf16 with f32 accumulators:
      q: q·e·2, k/v: 2·kv·e·2, scores: q·kv·4, out acc: q·e·4, stats: 2·q·4
    """
    best = (128, 128)
    for q in (128, 256, 512, 1024):
        for kv in (128, 256, 512, 1024):
            if q > seq or kv > seq:
                continue
            ws = (q * head_dim * 2 + 2 * kv * head_dim * 2
                  + q * kv * 4 + q * head_dim * 4 + 2 * q * 4)
            if ws <= explicit_bytes and (q, kv) >= best:
                best = (q, kv)
    return best


def _pick_mlp_blocks(d_model: int, d_ff: int, explicit_bytes: int
                     ) -> Tuple[int, int]:
    """(m_block, f_block): token tile × hidden tile for the fused MLP."""
    best = (128, 128)
    for m in (128, 256, 512):
        for f in (128, 256, 512, 1024):
            if f > d_ff:
                continue
            # x tile + w_up col tile + h tile + w_down row tile + out acc
            ws = (m * d_model * 2 + d_model * f * 2 * 2
                  + m * f * 4 + f * d_model * 2 + m * d_model * 4)
            if ws <= explicit_bytes and m * f >= best[0] * best[1]:
                best = (m, f)
    return best


def lower_codesign(cfg: ArchConfig, result: CoDesignResult,
                   seq: int = 4096, hw: HardwareModel = V5E) -> CelloPlan:
    """Translate a CoDesignResult on the layer graph into an execution plan.

    This is the lowering behind ``repro_torch.api.Session.lower()``."""
    sched = result.best.schedule
    explicit = sched.config.explicit_bytes or hw.vmem_bytes // 2

    def fused_together(*frags: str) -> bool:
        for group in sched.groups:
            names = ",".join(group)
            if all(f in names for f in frags):
                return True
        return False

    flash = fused_together(".scores", ".pv")
    fused_mlp = fused_together("mlp.up", "mlp.down")
    qb, kb = _pick_attention_blocks(cfg.resolved_head_dim, explicit, seq)
    mb, fb = _pick_mlp_blocks(cfg.d_model, cfg.d_ff, explicit)

    # pinned tensors -> checkpoint save-names (suffix match on known tags)
    saves = set()
    for tname in sched.pins:
        for tag in KNOWN_SAVE_NAMES:
            if tname.endswith(tag):
                saves.add(tag)
    # block outputs are always cheap to keep relative to recompute
    saves.update({"attn_out", "mlp_out"})
    if cfg.attention_free or cfg.hybrid_period:
        saves.add("rnn_state")

    return CelloPlan(
        arch=cfg.name,
        use_flash_attention=flash,
        q_block=qb, kv_block=kb,
        use_fused_mlp=fused_mlp,
        mlp_block_m=mb, mlp_block_f=fb,
        remat_save_names=tuple(sorted(saves)),
        explicit_frac=sched.config.explicit_frac,
        notes=(f"groups={len(sched.groups)} pins={len(sched.pins)} "
               f"speedup={result.speedup():.2f}x"),
    )


def default_plan(cfg: ArchConfig, seq: int = 4096,
                 hw: HardwareModel = V5E) -> CelloPlan:
    """Paper-faithful default without running the search (smoke tests,
    where search cost would dominate)."""
    explicit = hw.vmem_bytes // 2
    qb, kb = _pick_attention_blocks(cfg.resolved_head_dim, explicit, seq)
    mb, fb = _pick_mlp_blocks(cfg.d_model, cfg.d_ff, explicit)
    saves = {"attn_out", "mlp_out"}
    if cfg.attention_free or cfg.hybrid_period:
        saves.add("rnn_state")
    return CelloPlan(arch=cfg.name, q_block=qb, kv_block=kb,
                     mlp_block_m=mb, mlp_block_f=fb,
                     remat_save_names=tuple(sorted(saves)),
                     notes="default (no search)")
