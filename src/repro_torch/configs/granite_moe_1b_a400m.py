"""granite-moe-1b-a400m — MoE 32 experts, top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,                # per-expert FFN width
    vocab=49_155,
    activation="swiglu",
    n_experts=32,
    top_k=8,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
))
