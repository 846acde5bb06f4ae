"""Launch drivers of the port: LLM serving (``serve``)."""
from .serve import (ServeBundle, ServeStats, greedy_generate,
                    make_decode_fn, make_prefill_fn, make_serving)

__all__ = ["ServeBundle", "ServeStats", "greedy_generate", "make_decode_fn",
           "make_prefill_fn", "make_serving"]
