"""Each kernel's plain version against its JAX counterpart.

* B1 — the stream pass (``repro_torch.kernels.stream``) against the JAX
  package's ``_StreamCall`` (Pallas in interpret mode) on every stream unit
  of a plan, at rtol=2e-4 / atol=1e-5 (fp32) and 1e-9 / 1e-12 (fp64): the
  pass's reductions add their row blocks in another order;
* B2 — CSR SpMV against the reference rule ``eval_node`` for spmv;
* B4 — the periodic stencil against ``eval_node`` for stencil2d, bitwise.

Here on the CPU the wrappers take their plain versions; ``chip_smoke.py``
holds the CUDA kernels against these same plain versions on the card.  The
generated Triton source is parsed here for every pass of every workload.
"""
import ast

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as jx_api
import repro.frontends as jx_fe
from repro.exec.pallas import _StreamCall, _unit_needed
from repro.exec.reference import eval_node as jx_eval_node
import repro_torch.api as pt_api
import repro_torch.frontends as pt_fe
from repro_torch import kernels
from repro_torch.exec.cuda import CudaProgram, _StreamUnit
from repro_torch.kernels import build
from repro_torch.kernels.spmv import spmv, spmv_plain
from repro_torch.kernels.stencil import stencil2d, stencil2d_plain
from repro_torch.kernels.stream import StreamKernel, classify_nodes

TOL = {np.float32: dict(rtol=2e-4, atol=1e-5),
       np.float64: dict(rtol=1e-9, atol=1e-12)}

STREAM_SET = [
    ("cg", dict(n=96, iters=3)),
    ("bicgstab", dict(n=96, iters=2)),
    ("gmres", dict(n=96, restart=3)),
    ("power_iteration", dict(n=96, iters=3)),
    ("cg_sparse", dict(n=100, iters=3)),
    ("jacobi_sparse", dict(n=64, sweeps=3, pattern="skewed", density=0.1)),
]


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["fp32", "fp64"])
@pytest.mark.parametrize("workload,params", STREAM_SET,
                         ids=[w for w, _ in STREAM_SET])
def test_stream_units_match_pallas_stream_call(workload, params, dtype):
    """Every stream unit of the plan, run alone on the values the program
    computes, against ``_StreamCall.apply`` on the same values."""
    jx = jx_api.Session(use_cache=False).trace(workload=workload, **params)
    jx_plan = jx.analyze().codesign().lower()
    pt = pt_api.Session(device="cpu").trace(workload=workload, **params)
    pt_plan = pt.analyze().codesign().lower()
    feeds = jx_fe.make_feeds(jx.program, seed=1, dtype=dtype)
    with jax.enable_x64(dtype == np.float64):
        vals = {k: np.asarray(v) for k, v in
                jx_fe.evaluate(jx.program, feeds, return_all=True).items()}
        units = jx_plan.exec_plan.units
        needed = _unit_needed(jx.program, units)[0]
        n_stream = 0
        for ui, unit in enumerate(units):
            if unit.kind != "stream":
                continue
            n_stream += 1
            call = _StreamCall(jx.program, unit.sp, needed[ui])
            env = {n: jnp.asarray(vals[n]) for n in call.in_names}
            want = {k: np.asarray(v) for k, v in
                    call.apply(env, jnp.dtype(dtype)).items()}
            mine = _StreamUnit(pt.program, pt_plan.exec_plan.units[ui],
                               needed[ui])
            got = mine(pt_fe.feeds_from_numpy(
                {n: vals[n] for n in mine.in_names}))
            assert sorted(got) == sorted(want), (ui, unit.describe())
            for k in want:
                assert got[k].numpy().dtype == want[k].dtype
                np.testing.assert_allclose(got[k].numpy(), want[k],
                                           **TOL[dtype],
                                           err_msg=f"u{ui} {k}")
    assert n_stream > 0


def test_stream_kernel_outputs_and_classes():
    """A hand-built pass: matvec + dot + epilogue + eager glue."""
    p = pt_fe.Program("pass")
    A = p.operator("A", (40, 40), init="spd")
    x = p.input("x", (40,))
    s = p.input("s", (), init="const", value=2.0)
    y = p.matmul(A, x, name="y")
    yy = p.dot(y, y, name="yy")
    ns = p.neg(s, name="ns")
    z = p.axpy(ns, y, x, name="z")
    q = p.div(yy, s, name="q")
    p.output(z, q)
    nodes = [p.nodes[n] for n in ("y", "yy", "ns", "z", "q")]
    assert classify_nodes(nodes) == {"y": "tiled", "yy": "reduce",
                                     "ns": "eager", "z": "tiled",
                                     "q": "epilogue"}
    shapes = {n: p.nodes[n].shape for n in p.nodes}
    k = StreamKernel(nodes, shapes, {"z", "q", "yy"}, 40)
    assert k.stream_in == ["A", "x"] and k.res_in == ["x"]
    assert k.in_names == ["A", "x", "s"]
    assert k.stream_out == ["z"] and k.scalar_out == ["yy", "q"]
    env = pt_fe.feeds_from_numpy(pt_fe.make_feeds(p, seed=0,
                                                  dtype=np.float64))
    out = k(env)
    want = pt_fe.evaluate(p, env, return_all=True)
    for n in ("z", "q", "yy"):
        torch.testing.assert_close(out[n], want[n], rtol=1e-12, atol=1e-12)


def _ffn_plan():
    """``ab,bc->ac`` passes (2-D tiles, ``tl.dot``) of an FFN phase."""
    p = pt_fe.Program("ffn")
    x = p.input("x", (64, 24))
    h = p.matmul(x, p.operator("w_up", (24, 40)), name="up")
    g = p.matmul(x, p.operator("w_gate", (24, 40)), name="gate")
    p.output(p.matmul(p.mul(h, g, name="act"),
                      p.operator("w_down", (40, 24)), name="ffn_out"))
    return pt_api.Session.from_graph(p, device="cpu").codesign().lower()


def _all_stream_kernels():
    sess = pt_api.Session(device="cpu")
    plans = [(wl, sess.trace(workload=wl, **params).codesign().lower())
             for wl, params in STREAM_SET + [("jacobi2d",
                                              dict(n=16, sweeps=3))]]
    for wl, plan in plans + [("ffn", _ffn_plan())]:
        prog = CudaProgram(plan)
        for call in prog._pro + prog._tmpl + prog._epi:
            k = getattr(call, "pass_", None)
            if k is not None:
                yield wl, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["fp32", "fp64"])
def test_generated_triton_source_parses(dtype):
    seen = 0
    tags: dict = {}          # main kernel body -> tag
    repeats = 0              # passes whose main body an earlier one has
    deferred = 0             # deferred twins checked
    for wl, k in _all_stream_kernels():
        src = k.source(dtype)
        tree = ast.parse(src)
        names = [f.name for f in tree.body if isinstance(f, ast.FunctionDef)]
        # the prefixes kept, the main kernel's tag from its text (equal
        # bodies give equal tags, others differ) and the finalize kernel's
        # name the main tag and a tag of its own text
        tag = names[0][len("main_kernel_"):]
        ftag = names[1][len(f"finalize_kernel_{tag}_"):]
        assert names == [f"main_kernel_{tag}",
                         f"finalize_kernel_{tag}_{ftag}"], wl
        assert len(tag) == len(ftag) == 8, wl
        assert k.kernel_names(dtype) == (
            names[0], names[1] if k._fin_out else None), wl
        if k.red_out:
            # a deferred twin: the same main kernel; its finalize kernel
            # shares the ordinary one's name only where it has its text
            d = StreamKernel(k.nodes, k.shapes,
                             set(k.stream_out) | set(k.scalar_out), k.rows,
                             defer_finalize=True)
            main_d, fin_d = d.kernel_names(dtype)
            assert main_d == names[0], wl
            assert fin_d.startswith(f"finalize_kernel_{tag}_"), wl

            def fin_text(s):
                return s.split("def finalize_kernel")[1].split("(", 1)[1]

            same = fin_text(d.source(dtype)) == fin_text(src)
            assert (fin_d == names[1]) == same, wl
            deferred += not same
        main = tree.body[2]
        body = ast.dump(main.args) + "".join(map(ast.dump, main.body))
        repeats += body in tags
        assert tags.setdefault(body, tag) == tag, wl
        params = [a.arg for a in main.args.args]
        assert len(params) == len(set(params)), (wl, params)
        # fp32 division and square root round as IEEE (as torch's do)
        if dtype == torch.float32 and any(nd.op == "div" for nd in k.nodes):
            assert "tl.div_rn(" in src and " / " not in src
        assert k.source(dtype) == src            # deterministic text
        seen += 1
    assert seen > 10
    assert len(set(tags.values())) == len(tags) > 1 and repeats and deferred


def test_wrappers_refuse_other_devices():
    meta = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="devices"):
        kernels.on_cuda(meta)
    with pytest.raises(ValueError, match="devices"):
        kernels.on_cuda(torch.empty(4), meta)
    assert kernels.on_cuda(torch.empty(4)) is False


def test_nvcc_missing_is_reported(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(build.pathlib.Path, "exists", lambda _self: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build._nvcc()


def test_build_dir_and_digest(monkeypatch, tmp_path):
    monkeypatch.setenv("CELLO_TORCH_BUILD_DIR", str(tmp_path / "b"))
    assert build.build_dir() == tmp_path / "b"
    assert (tmp_path / "b").is_dir()
    assert {s.name for s in build._sources()} == {
        "spmv.cu", "stencil.cu", "flash_attention.cu", "fused_mlp.cu",
        "rmsnorm.cu", "rglru.cu", "wkv6.cu"}
    assert build._digest() == build._digest()


@pytest.mark.parametrize("pattern,kw", [
    ("laplacian5", {}), ("banded", dict(bandwidth=4)),
    ("random", dict(density=0.15)), ("skewed", dict(density=0.2))])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["fp32", "fp64"])
def test_spmv_plain_matches_reference_rule(pattern, kw, dtype):
    p = jx_fe.Program("spmv")
    A = p.sparse_operator("A", (64, 64), pattern=pattern, **kw)
    x = p.input("x", (64,))
    p.output(p.spmv(A, x, name="y"))
    feeds = jx_fe.make_feeds(p, seed=6, dtype=dtype)
    ins = [feeds[n] for n in p.nodes["y"].inputs]
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jx_eval_node(p.nodes["y"],
                                       [jnp.asarray(v) for v in ins]))
    t = pt_fe.feeds_from_numpy(dict(zip("ijdx", ins)))
    got = spmv(t["i"], t["j"], t["d"], t["x"], 64)
    assert torch.equal(got, spmv_plain(t["i"], t["j"], t["d"], t["x"], 64))
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])


#: B4's grids: the kernel's vector path (24x40), its scalar path (a width
#: no 16-byte vector divides), and grids of one to three rows or columns,
#: whose neighbours coincide
STENCIL_SHAPES = [(24, 40), (1000, 1003), (1, 1), (1, 5), (2, 3), (3, 2)]
#: (h2, f given, shape): the first three keep their ids from before the
#: shapes were added
STENCIL_CASES = [(1.0, True, (24, 40)), (0.5, True, (24, 40)),
                 (1.0, False, (24, 40))] + [
    (h2, with_f, shape) for shape in STENCIL_SHAPES[1:]
    for h2, with_f in ((0.5, True), (1.0, False))]


@pytest.mark.parametrize("h2,with_f,shape", STENCIL_CASES, ids=[
    f"{h2}-{with_f}" + ("" if shape == (24, 40) else
                        f"-{shape[0]}x{shape[1]}")
    for h2, with_f, shape in STENCIL_CASES])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["fp32", "fp64"])
def test_stencil_plain_is_bitwise_reference_rule(h2, with_f, shape, dtype):
    p = jx_fe.Program("st")
    u = p.input("u", shape)
    f = p.input("f", shape) if with_f else None
    p.output(p.stencil2d(u, f, h2=h2, name="v"))
    feeds = jx_fe.make_feeds(p, seed=8, dtype=dtype)
    ins = [feeds[n] for n in p.nodes["v"].inputs]
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jx_eval_node(p.nodes["v"],
                                       [jnp.asarray(v) for v in ins]))
    t = [torch.from_numpy(v) for v in ins]
    got = stencil2d(t[0], t[1] if with_f else None, h2)
    assert torch.equal(got, stencil2d_plain(t[0], t[1] if with_f else None,
                                            h2))
    np.testing.assert_array_equal(got.numpy(), want)


def test_block_unit_runs_elementwise_ops_between_sweeps():
    """A ``block`` unit mixing stencil sweeps and same-shape elementwise
    ops: the ops run as one stream pass over the flattened grids, the
    sweeps as B4 calls whose dead results free their scratch buffers."""
    from repro_torch.core.lowering import ExecUnit
    from repro_torch.exec.cuda import _BlockUnit
    p = pt_fe.Program("relax")
    u = p.input("u0", (24, 40))
    f = p.input("f", (24, 40))
    w = p.input("w", (), init="const", value=0.6)
    u1 = p.stencil2d(u, f, h2=0.5, name="u1")
    d = p.sub(u1, u, name="d")
    u2 = p.axpy(w, d, u, name="u2")
    u3 = p.stencil2d(u2, f, name="u3")
    u4 = p.stencil2d(u3, name="u4")
    p.output(p.add(p.stencil2d(u4, f, name="u5"), d, name="out"), d)
    unit = ExecUnit(tuple(p.schedulable_order()), "block")
    block = _BlockUnit(p, unit, set(p.outputs))
    assert [kind for kind, _ in block.steps] == [
        "stencil", "stream", "stencil", "stencil", "stencil", "stream"]
    assert block.steps[1][1].stream_out == ["d", "u2"]
    feeds = pt_fe.feeds_from_numpy(pt_fe.make_feeds(p, seed=2))
    got = block(feeds)
    want = pt_fe.evaluate(p, feeds)
    assert sorted(got) == sorted(want) == ["d", "out"]
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["fp32", "fp64"])
def test_stencil_kernel_bitwise_on_the_card(cuda_device, dtype):
    """B4 against its plain version, bitwise, at ``STENCIL_SHAPES`` and a
    path-sized grid, with f and without, and with u, f or out one element
    off 16-byte alignment (the kernel's scalar path)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device,
                           dtype=dtype)

    def hold(u, f, h2, out=None):
        got = stencil2d(u, f, h2, out=out)
        assert torch.equal(got, stencil2d_plain(u, f, h2)), (
            tuple(u.shape), f is None, h2)

    before = kernels.launches()["stencil2d"]
    for shape in STENCIL_SHAPES + [(1024, 1024)]:
        u, f = rnd(*shape), rnd(*shape)
        hold(u, f, 0.5)
        hold(u, None, 1.0)
    n0, n1 = 40, 1004
    buf = rnd(n0 * n1 + 1)
    shifted = buf[1:].view(n0, n1)
    assert shifted.data_ptr() % 16
    u = rnd(n0, n1)
    hold(shifted, u, 1.0)
    hold(u, shifted, 1.0, out=torch.empty_like(buf)[1:].view(n0, n1))
    assert kernels.launches()["stencil2d"] == before + 2 * (
        len(STENCIL_SHAPES) + 1) + 2
