"""ArchConfig: one dataclass drives the model zoo, the CELLO analyser,
the dry-run ``input_specs`` and the smoke tests.

Every assigned architecture registers an exact config (from the assignment
table) plus a ``reduced()`` variant used by CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

_REGISTRY: Dict[str, "ArchConfig"] = {}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    mode: str                    # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 ⇒ d_model // n_heads
    activation: str = "swiglu"   # swiglu | geglu | gelu
    # MoE
    n_experts: int = 0
    top_k: int = 0
    # attention structure
    window: Optional[int] = None          # sliding-window size (None = full)
    encoder_only: bool = False            # bidirectional, no decode
    cross_attn_every: int = 0             # vlm: cross-attn layer period
    vision_seq: int = 0                   # vlm: #patch embeddings
    # hybrid (recurrentgemma): layer pattern period; indices with attention
    hybrid_period: int = 0                # e.g. 3 ⇒ [rglru, rglru, attn]
    hybrid_attn_index: int = 2
    # ssm (rwkv6)
    attention_free: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so the embedding/LM-head shard
        over any TP axis ≤ 256 (Megatron-style vocab padding).  Labels are
        always < vocab, so padding columns only ever receive gradient
        pressure toward -inf — harmless."""
        return -(-self.vocab // 256) * 256

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode at 500k context with bounded state?"""
        return self.attention_free or self.hybrid_period > 0 or self.window is not None

    def layer_kinds(self) -> List[str]:
        """Per-layer block kind: 'attn' | 'rglru' | 'rwkv' | 'xattn'."""
        kinds = []
        for i in range(self.n_layers):
            if self.attention_free:
                kinds.append("rwkv")
            elif self.hybrid_period:
                kinds.append("attn" if i % self.hybrid_period == self.hybrid_attn_index
                             else "rglru")
            elif self.cross_attn_every and (i % self.cross_attn_every
                                            == self.cross_attn_every - 1):
                kinds.append("xattn")
            else:
                kinds.append("attn")
        return kinds

    def supported_shapes(self) -> List[str]:
        out = ["train_4k", "prefill_32k"]
        if not self.encoder_only:
            out.append("decode_32k")
            if self.subquadratic:
                out.append("long_500k")
        return out

    # parameter counts -------------------------------------------------
    def params_per_layer(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        attn = q + kv + o
        gated = self.activation in ("swiglu", "geglu")
        ff_in = (2 if gated else 1) * self.d_model * self.d_ff
        ff_out = self.d_ff * self.d_model
        if self.is_moe:
            ffn = self.n_experts * (ff_in + ff_out) + d * self.n_experts
        else:
            ffn = ff_in + ff_out
        norms = 2 * d
        kinds = self.layer_kinds()
        # non-attention blocks replace attn params
        rglru = 3 * d * d // 1 if any(k == "rglru" for k in kinds) else 0
        per_kind = {
            "attn": attn + ffn + norms,
            "xattn": attn + ffn + norms + kv,     # extra cross K/V proj
            "rglru": (2 * d * d + 2 * d * d) + ffn + norms,  # in/out proj + gates
            "rwkv": (4 * d * d + d * d) + ffn + norms,       # r,k,v,o,g proj
        }
        total = sum(per_kind[k] for k in kinds)
        return total // self.n_layers if self.n_layers else 0

    def total_params(self) -> int:
        kinds = self.layer_kinds()
        d, hd = self.d_model, self.resolved_head_dim
        gated = self.activation in ("swiglu", "geglu")
        ff_in = (2 if gated else 1) * self.d_model * self.d_ff
        ff_out = self.d_ff * self.d_model
        ffn = (self.n_experts * (ff_in + ff_out) + d * self.n_experts
               if self.is_moe else ff_in + ff_out)
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        per = {
            "attn": attn + ffn + 2 * d,
            "xattn": attn + ffn + 2 * d + 2 * d * self.n_kv_heads * hd,
            "rglru": 4 * d * d + ffn + 2 * d,
            "rwkv": 5 * d * d + ffn + 2 * d,
        }
        body = sum(per[k] for k in kinds)
        embed = self.vocab * d
        head = self.vocab * d          # untied LM head
        return body + embed + head

    def active_params(self) -> int:
        """MoE: params touched per token (for MODEL_FLOPS = 6·N_active·D)."""
        if not self.is_moe:
            return self.total_params()
        d = self.d_model
        gated = self.activation in ("swiglu", "geglu")
        ff_in = (2 if gated else 1) * self.d_model * self.d_ff
        ff_out = self.d_ff * self.d_model
        dense_ffn = self.top_k * (ff_in + ff_out) + d * self.n_experts
        full_ffn = self.n_experts * (ff_in + ff_out) + d * self.n_experts
        return self.total_params() - self.n_layers * (full_ffn - dense_ffn)

    # reduced config for CPU smoke tests --------------------------------
    def reduced(self) -> "ArchConfig":
        return dataclasses.replace(
            self,
            n_layers=max(2, min(3, self.n_layers)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 1,
            head_dim=16,
            d_ff=96 if not self.is_moe else 32,
            vocab=128,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            window=min(self.window, 32) if self.window else None,
            vision_seq=16 if self.vision_seq else 0,
            cross_attn_every=2 if self.cross_attn_every else 0,
            hybrid_period=self.hybrid_period,
            name=self.name + "-smoke",
        )


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> List[str]:
    return sorted(_REGISTRY)
