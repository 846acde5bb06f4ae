"""rwkv6-7b (Finch) — attention-free, data-dependent decay time-mix.
[arXiv:2404.05892; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,              # wkv head_size = 64 => 4096/64 heads
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab=65_536,
    activation="relu2",      # RWKV channel-mix: relu(x W_k)^2 W_v
    attention_free=True,
    source="arXiv:2404.05892",
))
