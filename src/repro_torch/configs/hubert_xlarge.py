"""hubert-xlarge — encoder-only audio transformer (wav2vec2-style backbone).
The conv feature-extractor frontend is a STUB: input_specs() provides
precomputed frame embeddings. No decode step exists (encoder-only).
[arXiv:2106.07447; unverified]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,               # CTC output vocabulary
    activation="gelu",
    encoder_only=True,
    source="arXiv:2106.07447",
))
