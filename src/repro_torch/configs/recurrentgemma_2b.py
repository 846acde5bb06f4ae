"""recurrentgemma-2b — RG-LRU + local attention hybrid, 1:2 attn:recurrent.
[arXiv:2402.19427; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,            # MQA on the local-attention layers
    head_dim=256,
    d_ff=7680,
    vocab=256_000,
    activation="geglu",
    window=2048,             # local attention window
    hybrid_period=3,         # [rglru, rglru, attn] repeating (1:2)
    hybrid_attn_index=2,
    source="arXiv:2402.19427",
))
