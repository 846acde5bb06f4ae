"""The run's environment and the checks that bound what it may load.

``prepare_env`` fixes every build and kernel cache of the program inside
the checkout, at paths that never move, before torch or Triton is
imported: the port's nvcc library and generated Triton sources
(``CELLO_TORCH_BUILD_DIR``), Triton's compile cache (``TRITON_CACHE_DIR``,
``TRITON_HOME``), the codesign cache (``CELLO_CACHE_DIR``) and CUDA's
JIT cache (``CUDA_CACHE_PATH``).  ``forbidden_modules`` and
``benchmarks_files`` find what the run must not have loaded: the JAX
package, JAX itself, or anything of the JAX package's benchmarks.
"""
from __future__ import annotations

import os
import pathlib
import sys
import time
from typing import List

#: top-level module names no run may load, compared whole: ``repro_torch``
#: begins with ``repro`` and is the program under test
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def prepare_env(root: pathlib.Path) -> pathlib.Path:
    build = root / "build"
    env = {
        "CELLO_TORCH_BUILD_DIR": build / "repro_torch",
        "TRITON_CACHE_DIR": build / "repro_torch" / "triton_cache",
        "TRITON_HOME": build / "triton_home",
        "CELLO_CACHE_DIR": build / "codesign_cache",
        "CUDA_CACHE_PATH": build / "cuda_cache",
    }
    for key, path in env.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[key] = str(path)
    os.environ.pop("CELLO_NO_CACHE", None)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    return build


def check_program_path(root: pathlib.Path) -> None:
    """The program must be the checkout's own ``src/repro_torch``."""
    import repro_torch
    where = pathlib.Path(repro_torch.__file__).resolve()
    if (root / "src") not in where.parents:
        raise ImportError(f"repro_torch loaded from {where}, not from "
                          f"{root / 'src'}")


def forbidden_modules() -> List[str]:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def benchmarks_files(root: pathlib.Path) -> List[str]:
    """Loaded modules whose file lies under the JAX package's
    ``benchmarks/`` folder."""
    bad = (root / "benchmarks").resolve()
    out = []
    for mod in list(sys.modules.values()):
        f = getattr(mod, "__file__", None)
        if f and bad in pathlib.Path(f).resolve().parents:
            out.append(f)
    return sorted(out)


def process_age_s() -> float:
    """Seconds since this process started, from ``/proc`` (10 ms steps);
    where that cannot be read, since this module was imported."""
    try:
        stat = pathlib.Path("/proc/self/stat").read_text()
        start_ticks = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(pathlib.Path("/proc/uptime").read_text().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _IMPORTED


_IMPORTED = time.monotonic()
