"""Model zoo of the port: every family of ``repro.models`` (dense, moe,
hybrid, ssm, vlm, audio)."""
from .common import COMPUTE_DTYPE, PARAM_DTYPE, rms_norm
from .convert import params_from_numpy
from .moe import apply_moe, init_moe_params, route
from .recurrent import (apply_rglru_seq, apply_rglru_step, apply_rwkv_seq,
                        apply_rwkv_step, init_rglru_params, init_rwkv_params)
from .transformer import (CacheSpec, decode_step, forward, init_cache,
                          init_params, period_structure)

__all__ = [
    "COMPUTE_DTYPE", "PARAM_DTYPE", "rms_norm", "params_from_numpy",
    "apply_moe", "init_moe_params", "route",
    "apply_rglru_seq", "apply_rglru_step", "apply_rwkv_seq",
    "apply_rwkv_step", "init_rglru_params", "init_rwkv_params",
    "CacheSpec", "decode_step", "forward", "init_cache", "init_params",
    "period_structure",
]
