"""The port's optimizer: AdamW, ZeRO-1's moment specs and int8 gradient
compression on its parameter tree (counterparts of ``repro.optim``)."""
from .adamw import (AdamWConfig, adamw_init, adamw_update, cosine_lr,
                    global_norm, zero1_pspecs)
from .compression import (CompressionState, compress_int8, decompress_int8,
                          error_feedback_compress)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr",
           "global_norm", "zero1_pspecs", "CompressionState", "compress_int8",
           "decompress_int8", "error_feedback_compress"]
