"""Hand-written Hopper kernels of the CUDA backend, each beside its plain
torch version.

  ``stream``   — B1, the fused row-streaming pass, generated as Triton
                 source per pass (plus its reduction-finalize kernel),
  ``spmv``     — B2, CSR SpMV, and B3, the same over an operand with an
                 overbooked pin (its row prefix's loads marked
                 evict_last in L2), CUDA C++ (``csrc/spmv.cu``), with B3's
                 arrangement (which op runs sliced, and where the prefix
                 ends); B3 counts as ``spmv_sliced``,
  ``stencil``  — B4, the periodic 5-point stencil, CUDA C++
                 (``csrc/stencil.cu``),
  ``flash_attention`` — B5, online-softmax attention, CUDA C++
                 (``csrc/flash_attention.cu``),
  ``fused_mlp`` — B6, the fused (gated) MLP, CUDA C++
                 (``csrc/fused_mlp.cu``),
  ``rmsnorm``  — B7, RMSNorm, CUDA C++ (``csrc/rmsnorm.cu``),
  ``rglru``    — B8, the RG-LRU scan, CUDA C++ (``csrc/rglru.cu``),
  ``rwkv6``    — B9, the WKV6 recurrence, CUDA C++ (``csrc/wkv6.cu``),
                 counted as ``wkv6``.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises — it never falls back.  ``LAUNCHES`` counts
kernel launches, one per launch, incremented in the wrappers and nowhere
else, so a run can show that its path went through the kernels.
"""
from typing import Dict

LAUNCHES: Dict[str, int] = {"stream": 0, "stream_finalize": 0, "spmv": 0,
                            "spmv_sliced": 0, "stencil2d": 0,
                            "flash_attention": 0,
                            "fused_mlp": 0, "rmsnorm": 0, "rglru": 0,
                            "wkv6": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launches() -> Dict[str, int]:
    """A copy of the launch counts."""
    return dict(LAUNCHES)


def on_cuda(*tensors) -> bool:
    """True when every tensor lies on a CUDA device, False when every one
    lies on the CPU; raises for a mix or any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"kernel operands on devices {sorted(kinds)}: need "
                     "all on one CUDA device or all on the CPU")
