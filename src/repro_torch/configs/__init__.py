"""Architecture configs: the 10 assigned architectures + registry (plain
data, copied from ``repro.configs``)."""
from .base import (ArchConfig, ShapeSpec, SHAPES, get_config, list_archs,
                   register)
from . import (recurrentgemma_2b, llama_3_2_vision_11b, rwkv6_7b,
               moonshot_v1_16b_a3b, granite_moe_1b_a400m, gemma_7b,
               h2o_danube_1_8b, minitron_8b, granite_3_8b, hubert_xlarge)

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "get_config", "list_archs",
           "register"]
