"""moonshot-v1-16b-a3b (Moonlight) — MoE 64 experts, top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,               # per-expert FFN width
    vocab=163_840,
    activation="swiglu",
    n_experts=64,
    top_k=6,
    source="hf:moonshotai/Moonlight-16B-A3B",
))
