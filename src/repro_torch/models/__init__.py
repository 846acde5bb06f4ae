"""Model zoo of the port: the dense family of ``repro.models``."""
from .common import COMPUTE_DTYPE, PARAM_DTYPE, rms_norm
from .convert import params_from_numpy
from .transformer import (CacheSpec, decode_step, forward, init_cache,
                          init_params, period_structure)

__all__ = [
    "COMPUTE_DTYPE", "PARAM_DTYPE", "rms_norm", "params_from_numpy",
    "CacheSpec", "decode_step", "forward", "init_cache", "init_params",
    "period_structure",
]
