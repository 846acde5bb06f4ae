"""minitron-8b — pruned nemotron; squared-ReLU MLP. [arXiv:2407.14679; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=256_000,
    activation="relu2",      # nemotron-family squared ReLU (non-gated)
    source="arXiv:2407.14679",
))
