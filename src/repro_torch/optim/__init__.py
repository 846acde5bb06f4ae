"""The port's optimizer: AdamW and int8 gradient compression on its
parameter tree (counterparts of ``repro.optim``; ZeRO-1's moment
shardings come with the LLM mesh)."""
from .adamw import (AdamWConfig, adamw_init, adamw_update, cosine_lr,
                    global_norm)
from .compression import (CompressionState, compress_int8, decompress_int8,
                          error_feedback_compress)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr",
           "global_norm", "CompressionState", "compress_int8",
           "decompress_int8", "error_feedback_compress"]
