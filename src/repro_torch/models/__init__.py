"""Model zoo of the port: every family of ``repro.models`` (dense, moe,
hybrid, ssm, vlm, audio), and the logical PartitionSpecs and mesh context
that ``launch.shardings`` and ``models.sharded`` split them by."""
from .common import (COMPUTE_DTYPE, PARAM_DTYPE, constrain, get_mesh,
                     named_sharding, pspec, resolve_axis, rms_norm,
                     set_mesh_context)
from .convert import params_from_numpy, pspecs_from_reference
from .moe import apply_moe, init_moe_params, moe_pspecs, route
from .recurrent import (apply_rglru_seq, apply_rglru_step, apply_rwkv_seq,
                        apply_rwkv_step, init_rglru_params, init_rwkv_params,
                        rglru_pspecs, rwkv_pspecs)
from .transformer import (CacheSpec, block_pspecs, cache_pspecs, decode_step,
                          forward, init_cache, init_params, param_pspecs,
                          period_structure)

__all__ = [
    "COMPUTE_DTYPE", "PARAM_DTYPE", "constrain", "get_mesh",
    "named_sharding", "pspec", "resolve_axis", "rms_norm",
    "set_mesh_context", "params_from_numpy", "pspecs_from_reference",
    "apply_moe", "init_moe_params", "moe_pspecs", "route",
    "apply_rglru_seq", "apply_rglru_step", "apply_rwkv_seq",
    "apply_rwkv_step", "init_rglru_params", "init_rwkv_params",
    "rglru_pspecs", "rwkv_pspecs",
    "CacheSpec", "block_pspecs", "cache_pspecs", "decode_step", "forward",
    "init_cache", "init_params", "param_pspecs", "period_structure",
]
