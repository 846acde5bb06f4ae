"""Launch drivers of the port: LLM serving (``serve``)."""
from .serve import (DecodeStep, ServeBundle, ServeStats, greedy_generate,
                    jit_decode_step, make_decode_fn, make_prefill_fn,
                    make_serving, reset_cache)

__all__ = ["DecodeStep", "ServeBundle", "ServeStats", "greedy_generate",
           "jit_decode_step", "make_decode_fn", "make_prefill_fn",
           "make_serving", "reset_cache"]
