"""llama-3.2-vision-11b — cross-attention image layers every 5th layer.
Vision frontend is a STUB: input_specs() provides precomputed patch
embeddings (4 tiles x 1601 patches, projected to d_model).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=128_256,
    activation="swiglu",
    cross_attn_every=5,      # 8 cross-attention layers in 40
    vision_seq=6404,         # 4 tiles x 1601 patch embeddings (stubbed)
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
))
