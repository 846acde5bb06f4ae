"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab=32_000,
    activation="swiglu",
    window=4096,             # sliding-window attention
    source="arXiv:2401.16818",
))
