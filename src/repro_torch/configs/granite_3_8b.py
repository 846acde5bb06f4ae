"""granite-3-8b — dense GQA. [hf:ibm-granite/granite-3.0-2b-base; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab=49_155,
    activation="swiglu",
    source="hf:ibm-granite/granite-3.0-2b-base",
))
