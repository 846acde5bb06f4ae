"""B1 at tiles wider than 256 columns, and its generated kernels executed
on the CPU.

B1 (``kernels/stream.py``) holds a ``(rows, C)`` tile as chunks of at most
``MAX_TILE_WIDTH`` columns when C is wider; a contraction whose left
operand is a tile of the block adds its K chunks' products in ascending
order, and so does the plain version.  Here:

* ``source()`` builds at C = 300 and K = 300 in all three forms (the
  single-request pass, ``LaneStreamKernel``, ``defer_finalize=True``), and
  a tile of at most 256 columns generates no chunk;
* the generated text runs on a small stand-in for ``triton`` /
  ``triton.language`` written on numpy (``_triton_stand_in``), launched by
  the wrappers' own ``launch`` code: each pass below agrees with its plain
  version within ``KERNEL_TOL`` (the stand-in's ``tl.dot`` and ``tl.sum``
  add in numpy's order, not Triton's), and whole workloads, as single,
  lane and mesh programs, agree with the reference backend within
  ``TOL``.  The stand-in checks what Triton
  would refuse at compile time: a block dimension that is not a power of
  two, a ``tl.dot`` operand narrower than 16;
* ``A (256 x 256) @ X (256 x 300) + X`` and an FFN pass at C = K = 384 run
  on the port's ``cuda`` backend within ``tests/test_torch_exec.py``'s
  ``TOL`` of the JAX package's ``pallas`` backend (interpret mode).

The card compiles the same text with Triton (``chip_smoke.py`` phase 3's
``check_off_path`` runs ``ffn_program(4096, 64, 384)``).
"""
import sys
import types

import jax
import numpy as np
import pytest
import torch

import repro.api as jx_api
import repro.frontends as jx_fe
import repro_torch.frontends as pt_fe
from repro_torch.api import Session
from repro_torch.exec.cuda import CudaLaneProgram, CudaProgram
from repro_torch.kernels import stream
from repro_torch.kernels.stream import (MAX_TILE_WIDTH, LaneStreamKernel,
                                        StreamKernel)

TOL = {np.float32: dict(rtol=2e-4, atol=1e-5),
       np.float64: dict(rtol=1e-9, atol=1e-12)}
#: the stand-in's kernels against the plain version, max |err| <= TOL x
#: max |plain| (as chip_smoke.py holds B1 on the card)
KERNEL_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
DTYPES = [np.float32, np.float64]
DT_IDS = ["fp32", "fp64"]


# ---------------------------------------------------------------------------
# a numpy stand-in for the parts of Triton that the generated passes use
# ---------------------------------------------------------------------------

class _Ptr:
    """A pointer into a tensor's flat storage plus an offset array."""

    def __init__(self, buf, off=0):
        self.buf, self.off = buf, off

    def __add__(self, o):
        return _Ptr(self.buf, self.off + o)

    __radd__ = __add__


def _pow2(n):
    assert n > 0 and n & (n - 1) == 0, f"block dimension {n}"


def _load(ptr, mask=None, other=None):
    off = np.asarray(ptr.off)
    if mask is None:
        return np.asarray(ptr.buf[off])
    off, mask = np.broadcast_arrays(off, np.asarray(mask))
    got = ptr.buf[np.where(mask, off, 0)]
    return np.where(mask, got, other).astype(ptr.buf.dtype)


def _store(ptr, val, mask=None):
    off = np.asarray(ptr.off)
    mask = np.ones(off.shape, bool) if mask is None else mask
    off, val, mask = np.broadcast_arrays(off, np.asarray(val), mask)
    ptr.buf[off[mask]] = val[mask]


def _dot(a, b, input_precision=None, out_dtype=None):
    assert a.ndim == b.ndim == 2 and min(*a.shape, *b.shape) >= 16, \
        (a.shape, b.shape)
    return a @ b


def _split(x):
    """Triton's ``tl.split``: the last axis, of length 2, into two."""
    x = np.asarray(x)
    assert x.shape[-1] == 2, x.shape
    return x[..., 0], x[..., 1]


def _arange(lo, hi):
    _pow2(hi - lo)
    return np.arange(lo, hi)


def _zeros(shape, dtype):
    for n in shape:
        _pow2(n)
    return np.zeros(shape, dtype)


class _Jit:
    pid = (0, 0)

    def __init__(self, fn):
        self.fn = fn

    def __getitem__(self, grid):
        def launch(*args, num_warps=None, enable_fp_fusion=None):
            assert enable_fp_fusion is False
            conv = [_Ptr(a.numpy().reshape(-1))
                    if isinstance(a, torch.Tensor) else a for a in args]
            g0, g1 = (*grid, 1)[:2]
            for p1 in range(g1):
                for p0 in range(g0):
                    _Jit.pid = (p0, p1)
                    self.fn(*conv)
        return launch


def _triton_stand_in():
    tl = types.ModuleType("triton.language")
    tl.float32, tl.float64 = np.float32, np.float64
    tl.program_id = lambda axis: _Jit.pid[axis]
    tl.arange, tl.zeros, tl.load, tl.store, tl.dot = (_arange, _zeros,
                                                      _load, _store, _dot)
    tl.sum = lambda x, axis=None: np.sum(x, axis=axis)
    tl.where = lambda c, a, b: np.where(c, a, b).astype(
        np.result_type(a, b))
    tl.broadcast_to = np.broadcast_to
    tl.reshape = lambda x, shape: np.reshape(x, shape)
    tl.split = _split
    tl.permute = lambda x, dims: np.transpose(x, dims)
    tl.div_rn = lambda a, b: a / b
    tl.sqrt_rn = tl.sqrt = np.sqrt
    triton = types.ModuleType("triton")
    triton.language = tl
    triton.jit = (lambda fn=None, **kw: _Jit(fn) if fn is not None
                  else _Jit)
    return triton, tl


@pytest.fixture
def generated_on_cpu(monkeypatch):
    """Every B1 pass launches its generated kernels through the stand-in,
    on CPU tensors; ``made`` lists the passes built meanwhile."""
    triton, tl = _triton_stand_in()
    monkeypatch.setitem(sys.modules, "triton", triton)
    monkeypatch.setitem(sys.modules, "triton.language", tl)

    def load(src):
        mod = types.ModuleType("stand_in_stream")
        exec(compile(src, "<generated>", "exec"), mod.__dict__)
        return mod
    monkeypatch.setattr(stream, "_load_source", load)
    monkeypatch.setattr(stream, "on_cuda", lambda *ts: True)
    made = []
    init = StreamKernel.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)
    monkeypatch.setattr(StreamKernel, "__init__", spy)
    return made


def _hold(kernel, env):
    """One pass through the stand-in against its plain version."""
    got, want = kernel.launch(env), kernel.plain(env)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        scale = float(w.double().abs().max()) if w.numel() else 0.0
        err = float((g.double() - w.double()).abs().max()) if w.numel() else 0
        assert err <= KERNEL_TOL[w.dtype] * max(scale, 1e-30), (k, err, scale)


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------

def wide_program(pkg, n=256, c=300):
    """``Y = A @ X + X``: one stream pass with a C-wide streamed tile, its
    product and its sum (``A`` SPD, near the identity: outputs of order 1,
    so fp32's rounding stays under the elementwise ``TOL``)."""
    p = pkg.Program("wide")
    A = p.operator("A", (n, n), init="spd")
    X = p.input("X", (n, c))
    p.output(p.add(p.matmul(A, X, name="AX"), X, name="Y"))
    return p


def ffn_program(pkg, m, d, f):
    """An FFN phase (``chip_smoke.py``'s): ``ab,bc->ac`` products with
    resident weights; at f > 256 both C (``up``, ``gate``, ``act``) and the
    K of ``ffn_out`` (a tile of the block) exceed 256."""
    p = pkg.Program("ffn")
    x = p.input("x", (m, d))
    h = p.matmul(x, p.operator("w_up", (d, f)), name="up")
    g = p.matmul(x, p.operator("w_gate", (d, f)), name="gate")
    p.output(p.matmul(p.mul(h, g, name="act"),
                      p.operator("w_down", (f, d)), name="ffn_out"))
    return p


def deferred_program(pkg, n=256, c=300):
    """A pass with a wide tile and a reduction, for the deferred form."""
    p = pkg.Program("wide_dot")
    A = p.operator("A", (n, n))
    X = p.input("X", (n, c))
    v = p.input("v", (n,))
    Y = p.add(p.matmul(A, X, name="AX"), X, name="Y")
    p.output(Y, p.norm(v, name="nv"))
    return p


def _pass_kernel(program, names, cls=StreamKernel, **kw):
    nodes = [program.nodes[o] for o in names]
    shapes = {n: program.nodes[n].shape
              for nd in nodes for n in (*nd.inputs, nd.name)}
    rows = shapes[names[0]][0]
    return cls(nodes, shapes, set(names), rows, **kw)


def _env(kernel, dtype, seed=0, lanes=None):
    rng = np.random.default_rng(seed)
    env = {}
    for n in kernel.in_names:
        shape = kernel.shapes[n]
        if lanes is not None and n in kernel.lanes:
            shape = (lanes, *shape)
        env[n] = torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    return env


# ---------------------------------------------------------------------------
# source() at C = 300 and K = 300
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=DT_IDS)
@pytest.mark.parametrize("form", ["single", "lanes", "deferred"])
@pytest.mark.parametrize("wide", ["C", "K"])
def test_source_builds_past_256_columns(wide, form, dtype):
    n, c = 256, 300
    if wide == "C":
        prog = deferred_program(pt_fe, n, c) if form == "deferred" \
            else wide_program(pt_fe, n, c)
        names = ["AX", "Y", "nv"] if form == "deferred" else ["AX", "Y"]
    else:                    # K = 300: the left operand a tile of the block
        prog = ffn_program(pt_fe, n, 64, c)
        names = ["up", "gate", "act", "ffn_out"]
    if form == "lanes":
        kernel = _pass_kernel(prog, names, LaneStreamKernel,
                              lanes={"X", "x", "v"})
    else:
        kernel = _pass_kernel(prog, names,
                              defer_finalize=form == "deferred")
    src = kernel.source(dtype)
    compile(src, "<generated>", "exec")
    assert f"c{c}_0 = tl.arange(0, {MAX_TILE_WIDTH})" in src
    assert f"c{c}_1 = {MAX_TILE_WIDTH} + tl.arange(0, 64)" in src
    assert f"c{c}_1m = c{c}_1 < {c}" in src
    if wide == "K":          # K chunks of the block's own tile, in order
        assert "tl.dot(tl.where(c300_1m[None, :]" in src


@pytest.mark.parametrize("c", [16, 200, MAX_TILE_WIDTH])
def test_tiles_up_to_256_columns_have_no_chunks(c):
    kernel = _pass_kernel(wide_program(pt_fe, 64, c), ["AX", "Y"])
    src = kernel.source(torch.float32)
    assert f"c{c} = tl.arange(0, {stream._pw(c)})" in src
    assert f"c{c}_0" not in src and "_c0" not in src


def test_reduction_over_a_matrix_tile_raises_clearly():
    p = pt_fe.Program("mnorm")
    X = p.input("X", (64, 8))
    p.output(p.norm(p.add(X, X, name="Y"), name="nY"))
    kernel = _pass_kernel(p, ["Y", "nY"])
    with pytest.raises(NotImplementedError, match=r"\(rows, C\) tile"):
        kernel.source(torch.float32)


def test_plain_version_adds_k_chunks_in_order():
    """At K > 256 with the left operand a tile of the block, the plain
    version is the sum of the K chunks' products in ascending order."""
    prog = ffn_program(pt_fe, 32, 16, 600)
    kernel = _pass_kernel(prog, ["up", "gate", "act", "ffn_out"])
    env = _env(kernel, torch.float32, seed=3)
    got = kernel.plain(env)["ffn_out"]
    act = (env["x"] @ env["w_up"]) * (env["x"] @ env["w_gate"])
    w = env["w_down"]
    want = act[:, :256] @ w[:256]
    want = want + act[:, 256:512] @ w[256:512]
    want = want + act[:, 512:] @ w[512:]
    assert torch.equal(got, want)
    small = _pass_kernel(ffn_program(pt_fe, 32, 16, 256),
                         ["up", "gate", "act", "ffn_out"])
    env = _env(small, torch.float32, seed=3)
    act = (env["x"] @ env["w_up"]) * (env["x"] @ env["w_gate"])
    assert torch.equal(small.plain(env)["ffn_out"], act @ env["w_down"])


# ---------------------------------------------------------------------------
# the generated kernels, executed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=DT_IDS)
@pytest.mark.parametrize("case", ["wide_C300", "ffn_CK384", "ffn_CK256",
                                  "deferred_C300", "lanes_C300",
                                  "lanes_ffn_CK384"])
def test_generated_pass_matches_plain(case, dtype, generated_on_cpu):
    lanes = None
    if case == "wide_C300":
        kernel = _pass_kernel(wide_program(pt_fe, 64, 300), ["AX", "Y"])
    elif case.startswith("ffn"):
        f = int(case[-3:])
        kernel = _pass_kernel(ffn_program(pt_fe, 48, 32, f),
                              ["up", "gate", "act", "ffn_out"])
    elif case == "deferred_C300":
        kernel = _pass_kernel(deferred_program(pt_fe, 64, 300),
                              ["AX", "Y", "nv"], defer_finalize=True)
    elif case == "lanes_C300":
        kernel = _pass_kernel(wide_program(pt_fe, 64, 300), ["AX", "Y"],
                              LaneStreamKernel, lanes={"X"})
        lanes = 3
    else:
        kernel = _pass_kernel(ffn_program(pt_fe, 32, 16, 384),
                              ["up", "gate", "act", "ffn_out"],
                              LaneStreamKernel, lanes={"x"})
        lanes = 2
    _hold(kernel, _env(kernel, dtype, lanes=lanes))


@pytest.mark.parametrize("workload,params", [
    ("cg", dict(n=64, iters=3)), ("bicgstab", dict(n=64, iters=2)),
    ("gmres", dict(n=32, restart=3)),
    ("power_iteration", dict(n=64, iters=2)),
    ("cg_sparse", dict(n=64, iters=3)),
    ("jacobi_sparse", dict(n=64, sweeps=2)),
])
def test_generated_passes_run_the_workloads(workload, params,
                                            generated_on_cpu):
    """Every pass of a workload's plan, single, lane and mesh program
    (deferred B1), through the stand-in: the outputs within ``TOL`` of the
    reference backend's."""
    traced = Session(device="cpu").trace(workload=workload, **params)
    plan = traced.analyze().codesign().lower()
    feeds = pt_fe.feeds_from_numpy(pt_fe.make_feeds(plan.trace.program,
                                                    seed=1))
    got = CudaProgram(plan)(feeds)
    assert generated_on_cpu, "no B1 pass built"
    want = plan.run(feeds, backend="reference")
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   **TOL[np.float32], err_msg=k)
    lane = CudaLaneProgram(plan)
    shared = {n: feeds[n] for n in lane.shared_leaves}
    batched = {n: torch.stack([feeds[n]] * 2) for n in lane.batched_leaves}
    lanes = lane(shared, batched)
    for k in want:
        for i in range(2):
            np.testing.assert_allclose(lanes[k][i].numpy(), want[k].numpy(),
                                       **TOL[np.float32], err_msg=k)
    generated_on_cpu.clear()
    sharded = traced.analyze().codesign().lower(mesh=4).run(feeds)
    assert any(k.defer for k in generated_on_cpu), "no deferred pass built"
    for k in want:
        np.testing.assert_allclose(sharded[k].numpy(), want[k].numpy(),
                                   **TOL[np.float32], err_msg=k)


# ---------------------------------------------------------------------------
# the whole plan against the JAX package's pallas backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("case", ["wide_C300", "ffn_CK384"])
def test_wide_plan_matches_jax_pallas(case, dtype, generated_on_cpu,
                                      monkeypatch):
    """The port's ``cuda`` backend with its generated kernels (through
    the stand-in) and with the plain versions, against the JAX package's
    ``pallas`` backend in interpret mode."""
    def build(pkg):
        return (wide_program(pkg, 256, 300) if case == "wide_C300"
                else ffn_program(pkg, 64, 32, 384))
    jx_plan = jx_api.Session.from_graph(build(jx_fe), use_cache=False) \
        .codesign().lower()
    pt_plan = Session.from_graph(build(pt_fe), device="cpu").codesign() \
        .lower()
    feeds = jx_fe.make_feeds(jx_plan.trace.program, seed=2, dtype=dtype)
    for w in ("w_up", "w_gate", "w_down"):      # outputs of order 1
        if w in feeds:
            feeds[w] = feeds[w] / np.sqrt(feeds[w].shape[0]).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        pal = {k: np.asarray(v) for k, v in
               jx_plan.run(feeds, backend="pallas").items()}
    pt_feeds = pt_fe.feeds_from_numpy(feeds)
    got = pt_plan.run(pt_feeds)
    assert any(max(s[-1] for s in k.shapes.values() if len(s) == 2) > 256
               for k in generated_on_cpu), "no wide pass built"
    for k in pal:
        assert got[k].numpy().dtype == pal[k].dtype == dtype
        np.testing.assert_allclose(got[k].numpy(), pal[k], **TOL[dtype],
                                   err_msg=f"{case} {k}")
    monkeypatch.setattr(stream, "on_cuda", lambda *ts: False)   # plain
    plain = pt_plan.run(pt_feeds, backend="cuda-perunit")
    for k in pal:
        np.testing.assert_allclose(plain[k].numpy(), pal[k], **TOL[dtype],
                                   err_msg=f"{case} {k} plain")
