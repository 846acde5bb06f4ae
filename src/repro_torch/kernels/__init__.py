"""Hand-written Hopper kernels of the CUDA backend, each beside its plain
torch version.

  ``stream``   — B1, the fused row-streaming pass, generated as Triton
                 source per pass (plus its reduction-finalize kernel),
  ``spmv``     — B2, CSR SpMV, and B3, CSR SpMV over an operand with an
                 overbooked pin (row tiles staged in shared memory, the
                 prefix tiles' copies marked evict_last in L2), CUDA C++
                 (``csrc/spmv.cu``), with B3's arrangement (which op runs
                 sliced, and where the prefix ends); B3 counts as
                 ``spmv_sliced``,
  ``stencil``  — B4, the periodic 5-point stencil, CUDA C++
                 (``csrc/stencil.cu``),
  B1, B2, B3 and B4 also have a lane form for batched serving (one
                 launch serves L requests, the shared operator read once;
                 counted as ``stream_lanes`` / ``stream_lanes_finalize``,
                 ``spmv_lanes``, ``spmv_sliced_lanes``, ``stencil2d_lanes``),
  B1 also has a deferred-finalize mode for the shards of a mesh-partitioned
                 plan (raw reduction sums, no scalar chain; counted as
                 ``stream_deferred`` / ``stream_deferred_finalize``),
  ``flash_attention`` — B5, online-softmax attention, CUDA C++
                 (``csrc/flash_attention.cu``),
  ``fused_mlp`` — B6, the fused (gated) MLP, CUDA C++
                 (``csrc/fused_mlp.cu``),
  ``rmsnorm``  — B7, RMSNorm, CUDA C++ (``csrc/rmsnorm.cu``),
  ``rglru``    — B8, the RG-LRU scan, CUDA C++ (``csrc/rglru.cu``),
  ``rwkv6``    — B9, the WKV6 recurrence in its chunked form, CUDA C++
                 (``csrc/wkv6.cu``), counted as ``wkv6``.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises — it never falls back.  A kernel that does
not build or launch raises ``build.KernelError``.  Every wrapper calls
:func:`count` once per launch, right where it launches, and nowhere else,
so a run can show that its path went through the kernels:

* ``LAUNCHES`` holds the process-wide counts (incremented under a lock;
  :func:`launches` copies them, :func:`reset_launches` zeroes them);
* :func:`counting` opens a counter for the calling thread alone and
  yields it: it sees the launches that this thread makes while it is
  open, whatever other threads launch meanwhile.  Scopes nest, and every
  open one counts.  ``exec.cuda.CudaProgram`` counts its runs so;
* :func:`capturing` opens a counter that takes the calling thread's
  counts for itself: while it is open, ``count`` adds to it alone, and
  neither to ``LAUNCHES`` nor to any ``counting`` scope.  A CUDA graph's
  capture runs inside one (a captured launch runs nothing on the
  device), and every replay of the graph then calls ``count(name, n)``
  with the capture's counts, so the counts keep meaning kernels run on
  the device.

B5–B9 also run on ``meta`` tensors: the wrapper checks its arguments as
on the card and returns empty outputs of the kernel's shapes and dtypes,
and launches nothing (``on_cuda(..., meta=True)``).  Each of their
modules has ``work(...) -> (flops, nbytes)``, the function's operations
and its least bytes, and the wrapper reports that work with
:func:`report_work` on meta and on the card alike, beside its
``count``; :func:`costing` opens a scope that sums it.  The
dry run (``launch.dryrun``) counts a step's kernels so.
"""
import contextlib
import threading
from typing import Dict, Iterator, List

LAUNCHES: Dict[str, int] = {"stream": 0, "stream_finalize": 0, "spmv": 0,
                            "spmv_sliced": 0, "stencil2d": 0,
                            "stream_lanes": 0, "stream_lanes_finalize": 0,
                            "spmv_lanes": 0, "spmv_sliced_lanes": 0,
                            "stencil2d_lanes": 0,
                            "stream_deferred": 0,
                            "stream_deferred_finalize": 0,
                            "flash_attention": 0,
                            "fused_mlp": 0, "rmsnorm": 0, "rglru": 0,
                            "wkv6": 0}


_lock = threading.Lock()
_local = threading.local()

#: the kernels that report their work (B5–B9)
WORK_KERNELS = ("flash_attention", "fused_mlp", "rmsnorm", "rglru", "wkv6")


def count(name: str, n: int = 1) -> None:
    """``n`` launches of kernel ``name``: the process-wide count and every
    counter that the calling thread has open, or, while the thread has a
    :func:`capturing` counter open, that counter alone."""
    if name not in LAUNCHES:
        raise KeyError(name)
    capture = getattr(_local, "capture", None)
    if capture:
        capture[-1][name] += n
        return
    with _lock:
        LAUNCHES[name] += n
    for open_counter in getattr(_local, "open", ()):
        open_counter[name] += n


@contextlib.contextmanager
def counting() -> Iterator[Dict[str, int]]:
    """A counter of the launches that the calling thread makes inside the
    block, one entry per kernel of ``LAUNCHES``."""
    stack = _local.__dict__.setdefault("open", [])
    counter = dict.fromkeys(LAUNCHES, 0)
    stack.append(counter)
    try:
        yield counter
    finally:
        stack.pop()                  # scopes close innermost first


@contextlib.contextmanager
def capturing() -> Iterator[Dict[str, int]]:
    """A counter that takes the launches the calling thread makes inside
    the block for itself (see the module's docstring)."""
    stack = _local.__dict__.setdefault("capture", [])
    counter = dict.fromkeys(LAUNCHES, 0)
    stack.append(counter)
    try:
        yield counter
    finally:
        stack.pop()


#: the open :func:`costing` scopes, process-wide (a backward on the card
#: runs on autograd's device thread, and its kernels count all the same)
_COSTS: List[Dict[str, Dict[str, int]]] = []


def report_work(name: str, flops: int, nbytes: int) -> None:
    """One call of kernel ``name`` doing ``flops`` operations on ``nbytes``
    least bytes, added to every open :func:`costing` scope."""
    if name not in WORK_KERNELS:
        raise KeyError(name)
    with _lock:
        for scope in _COSTS:
            entry = scope[name]
            entry["calls"] += 1
            entry["flops"] += flops
            entry["bytes"] += nbytes


@contextlib.contextmanager
def costing() -> Iterator[Dict[str, Dict[str, int]]]:
    """Per kernel of ``WORK_KERNELS``, the ``calls``, ``flops`` and
    ``bytes`` that the wrappers report while the block is open, from any
    thread (as ``LAUNCHES`` counts)."""
    scope = {k: {"calls": 0, "flops": 0, "bytes": 0} for k in WORK_KERNELS}
    with _lock:
        _COSTS.append(scope)
    try:
        yield scope
    finally:
        with _lock:
            _COSTS.remove(scope)


def reset_launches() -> None:
    with _lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launches() -> Dict[str, int]:
    """A copy of the launch counts."""
    with _lock:
        return dict(LAUNCHES)


def on_cuda(*tensors, meta: bool = False) -> bool:
    """True when every tensor lies on a CUDA device, False when every one
    lies on the CPU; raises for a mix or any other device.  With ``meta``
    (B5–B9) every tensor on the meta device is True too: the wrapper then
    takes the kernel's path up to its launch."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} or (meta and kinds == {"meta"}):
        return True
    raise ValueError(f"kernel operands on devices {sorted(kinds)}: need "
                     "all on one CUDA device or all on the CPU"
                     + (" (or all on meta)" if meta else ""))
