"""Build and load the port's kernels.

CUDA C++ sources (``repro_torch/csrc/*.cu``) are compiled at first use with
``nvcc`` for ``sm_90a`` — one ``nvcc -c`` per source, all started together,
then one link — into a single shared library with a plain C interface,
loaded with ``ctypes``.  Generated Triton sources (``kernels.stream``) are
written to the same build directory and imported from there, and Triton's
own compile cache goes there too: every import of Triton in the port goes
through :func:`import_triton`, which sets ``TRITON_CACHE_DIR`` (unless the
caller set it) before Triton is first imported.

The build directory is ``<checkout>/build/repro_torch`` (``build/`` is
git-ignored), or ``$CELLO_TORCH_BUILD_DIR``.  The library's file name
carries a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads the library already built.  Nothing here runs at
import time: this module imports on a machine without ``nvcc``.

A kernel that does not build, load or launch raises :class:`KernelError`,
here and in ``kernels.stream`` for the Triton passes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import List, Optional

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"

#: ``-Xptxas -v`` prints each kernel's registers, shared memory and spills
#: into the build log (``build.log`` beside the library)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")



class KernelError(RuntimeError):
    """A hand-written kernel did not build (``nvcc`` or Triton refused
    it, or the library did not load) or did not launch (a C entry
    reported a CUDA error).  Nothing in the port answers it with a plain
    version: ``serve.Server`` settles it on the batch's futures instead of
    retrying or falling back."""


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: wall-clock seconds the last library build took (0.0 when it was loaded)
build_seconds = 0.0


def build_dir() -> pathlib.Path:
    env = os.environ.get("CELLO_TORCH_BUILD_DIR")
    root = (pathlib.Path(env) if env else
            pathlib.Path(__file__).resolve().parents[3] / "build"
            / "repro_torch")
    root.mkdir(parents=True, exist_ok=True)
    return root


def import_triton():
    """Triton, with its compile cache under the build directory."""
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(build_dir() / "triton_cache"))
    try:
        import triton
    except ImportError as e:
        raise KernelError(f"triton does not import: {e}") from e
    return triton


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelError("nvcc not found: the CUDA backend needs the CUDA "
                      "toolkit to build its kernels (csrc/*.cu)")


def _sources() -> List[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(repr(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    """argtypes of every C entry: each pointer and the stream as
    ``c_void_p`` (ctypes would cut a bare int to 32 bits)."""
    vp, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in ("cello_spmv_f32", "cello_spmv_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, vp, vp, i32, i32, vp]
        fn.restype = i32
    lib.cello_spmv_shape.argtypes = [i32, i32, vp]
    lib.cello_spmv_shape.restype = i32
    for name in ("cello_spmv_sliced_f32", "cello_spmv_sliced_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, vp, vp, i32, i32, vp]
        fn.restype = i32
    for name in ("cello_stencil2d_f32", "cello_stencil2d_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, i32, i32, f64, vp]
        fn.restype = i32
    for name in ("cello_spmv_lanes_f32", "cello_spmv_lanes_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, vp]
        fn.restype = i32
    for name in ("cello_spmv_sliced_lanes_f32",
                 "cello_spmv_sliced_lanes_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32, vp]
        fn.restype = i32
    for name in ("cello_spmv_sliced_lanes_shape_f32",
                 "cello_spmv_sliced_lanes_shape_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp]
        fn.restype = i32
    for name in ("cello_stencil2d_lanes_f32", "cello_stencil2d_lanes_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, i32, i32, f64, i32, i32, i32, vp]
        fn.restype = i32
    for name in ("cello_rmsnorm_bf16", "cello_rmsnorm_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, i32, f64, vp]
        fn.restype = i32
    for name in ("cello_flash_attention_bf16", "cello_flash_attention_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32,
                       f64, i32, i32, vp]
        fn.restype = i32
    for name in ("cello_fused_mlp_bf16", "cello_fused_mlp_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32,
                       vp]
        fn.restype = i32
    for name in ("cello_rglru_bf16", "cello_rglru_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, vp]
        fn.restype = i32
    for name in ("cello_wkv6_bf16", "cello_wkv6_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32,
                       vp]
        fn.restype = i32


def _compile(out: pathlib.Path) -> None:
    nvcc = _nvcc()
    work = out.with_suffix(".tmp")
    work.mkdir(exist_ok=True)
    jobs = []
    for src in _sources():
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    failed = []
    for cmd, _obj, proc in jobs:
        text, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(cmd[-3])
    tmp_lib = work / out.name
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS[:4], "-shared",
               *[str(obj) for _c, obj, _p in jobs], "-o", str(tmp_lib)]
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout)
        if res.returncode != 0:
            failed.append("link")
    (out.parent / "build.log").write_text("\n".join(log))
    if failed:
        raise KernelError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    os.replace(tmp_lib, out)          # atomic: a reader never sees half
    shutil.rmtree(work, ignore_errors=True)


def cuda_library() -> ctypes.CDLL:
    """The compiled kernel library, built on first call."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            out = build_dir() / f"libcello_kernels-{_digest()}.so"
            t0 = time.perf_counter()
            if not out.exists():
                _compile(out)
            build_seconds = time.perf_counter() - t0
            try:
                lib = ctypes.CDLL(str(out))
                _declare(lib)
            except (OSError, AttributeError) as e:
                raise KernelError(f"kernel library {out.name} does not "
                                  f"load: {e}") from e
            _lib = lib
        return _lib


def build_log() -> str:
    """The last build's compiler output (``-Xptxas -v`` included)."""
    path = build_dir() / "build.log"
    return path.read_text() if path.exists() else ""


def check(err: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error (a refused launch never
    runs, and ``torch.cuda.synchronize`` would not report it)."""
    if err != 0:
        raise KernelError(f"{what}: CUDA error {err}")
