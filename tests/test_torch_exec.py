"""The port's execution backends against the JAX package's.

Tolerances (the JAX package's documented policy): float32 at rtol=2e-4 /
atol=1e-5 and float64 at rtol=1e-9 / atol=1e-12 across the two packages —
contractions go through different BLAS and tiled reductions re-associate
their sums; the port's scheduled order against its own natural order is
bitwise.  Here on the CPU the ``cuda`` backend runs every kernel's plain
version (the CUDA kernels themselves are checked by ``chip_smoke.py`` on
the card).
"""
import jax
import numpy as np
import pytest
import torch

import repro.api as jx_api
import repro.frontends as jx_fe
import repro_torch.api as pt_api
import repro_torch.frontends as pt_fe
from repro_torch import kernels

TOL = {np.float32: dict(rtol=2e-4, atol=1e-5),
       np.float64: dict(rtol=1e-9, atol=1e-12)}

EXEC_SET = [
    ("cg", dict(n=64, iters=4)),
    ("bicgstab", dict(n=64, iters=3)),
    ("gmres", dict(n=64, restart=3)),
    ("jacobi2d", dict(n=16, sweeps=3)),
    ("power_iteration", dict(n=64, iters=3)),
    ("mttkrp", dict(i=8, j=8, k=8, rank=4)),
    ("cg_sparse", dict(n=64, iters=4)),
    ("bicgstab_sparse", dict(n=64, iters=3, pattern="random",
                             density=0.1)),
    ("jacobi_sparse", dict(n=64, sweeps=3, pattern="banded", bandwidth=3)),
]
IDS = [w for w, _ in EXEC_SET]


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _close(got, want, dtype, what=""):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), **TOL[dtype],
                                   err_msg=f"{what} {k}")


def _plans(workload, params):
    jx = jx_api.Session(use_cache=False).trace(workload=workload, **params)
    pt = pt_api.Session(device="cpu").trace(workload=workload, **params)
    return (jx, jx.analyze().codesign().lower(),
            pt, pt.analyze().codesign().lower())


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["fp32", "fp64"])
@pytest.mark.parametrize("workload,params", EXEC_SET, ids=IDS)
def test_reference_matches_jax_reference(workload, params, dtype):
    jx_prog = jx_fe.build_workload(workload, **params)
    pt_prog = pt_fe.build_workload(workload, **params)
    feeds = jx_fe.make_feeds(jx_prog, seed=7, dtype=dtype)
    with jax.enable_x64(dtype == np.float64):
        want = jx_fe.evaluate(jx_prog, feeds)
        want = {k: np.asarray(v) for k, v in want.items()}
    got = pt_fe.evaluate(pt_prog, pt_fe.feeds_from_numpy(feeds))
    for k in got:
        assert got[k].numpy().dtype == want[k].dtype, k
    _close(got, want, dtype, workload)


@pytest.mark.parametrize("workload,params", EXEC_SET, ids=IDS)
def test_scheduled_order_is_bitwise_natural_order(workload, params):
    traced = pt_api.Session(device="cpu").trace(workload=workload, **params)
    plan = traced.analyze().codesign().lower(backend="reference")
    feeds = pt_fe.feeds_from_numpy(pt_fe.make_feeds(traced.program, seed=5))
    want = pt_fe.evaluate(traced.program, feeds)
    got = plan.run(feeds)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("workload,params", EXEC_SET, ids=IDS)
def test_cuda_backend_matches_pallas_and_reference(workload, params):
    jx, jx_plan, pt, pt_plan = _plans(workload, params)
    assert pt_plan.backend == "cuda"
    feeds = jx_fe.make_feeds(jx.program, seed=7)
    pal = {k: np.asarray(v) for k, v in
           jx_plan.run(feeds, backend="pallas").items()}
    before = kernels.launches()
    got = pt_plan.run(pt_fe.feeds_from_numpy(feeds))
    # on CPU tensors every wrapper takes its plain version: no launches
    assert kernels.launches() == before
    _close(got, pal, np.float32, f"{workload} cuda vs pallas")
    ref = pt_plan.run(pt_fe.feeds_from_numpy(feeds), backend="reference")
    _close(got, ref, np.float32, f"{workload} cuda vs reference")
    stats = pt_plan.compiled().stats
    assert stats["runs"] == 1 and set(stats["launches"]) == set(
        kernels.LAUNCHES)


@pytest.mark.parametrize("workload,params", EXEC_SET, ids=IDS)
def test_cuda_backend_fp64_matches_reference(workload, params):
    traced = pt_api.Session(device="cpu").trace(workload=workload, **params)
    plan = traced.analyze().codesign().lower()
    feeds = pt_fe.feeds_from_numpy(
        pt_fe.make_feeds(traced.program, seed=2, dtype=np.float64))
    got = plan.run(feeds)
    assert all(v.dtype == torch.float64 for v in got.values())
    _close(got, plan.run(feeds, backend="reference"), np.float64, workload)


def test_run_without_feeds_uses_seeded_feeds():
    plan = (pt_api.Session(device="cpu").trace(workload="cg", n=64, iters=2)
            .codesign().lower())
    a, b = plan.run(seed=4), plan.run(seed=4)
    c = plan.run(pt_fe.feeds_from_numpy(
        pt_fe.make_feeds(plan.trace.program, seed=4)))
    for k in a:
        assert torch.equal(a[k], b[k]) and torch.equal(a[k], c[k])


def test_feeds_from_numpy_keeps_dtypes_and_shapes():
    prog = pt_fe.build_workload("cg_sparse", n=64, iters=1)
    # 2.0 becomes a rank-0 const leaf
    prog.output(prog.mul(2.0, pt_fe.Expr(prog, "b"), name="b2"))
    for dt in (np.float32, np.float64):
        np_feeds = pt_fe.make_feeds(prog, dtype=dt)
        feeds = pt_fe.feeds_from_numpy(np_feeds)
        assert feeds["A.indptr"].dtype == torch.int32
        assert feeds["A.indices"].dtype == torch.int32
        assert feeds["A.data"].numpy().dtype == dt
        assert feeds["b"].device.type == "cpu"
        for k, v in np_feeds.items():
            assert tuple(feeds[k].shape) == v.shape, k
        assert any(v.shape == () for v in np_feeds.values())


def test_overbooked_prefix_pins_need_b3():
    """A plan with a prefix pin runs its spmv ops on B3 (the sliced SpMV)
    and matches the JAX package's pallas backend; more such plans, fp64
    and the arrangement are in ``test_torch_overbook.py``."""
    params = dict(n=64, iters=3, pattern="banded", bandwidth=2)
    jx = jx_api.Session(use_cache=False).trace(workload="cg_sparse",
                                               **params)
    traced = pt_api.Session(device="cpu").trace(workload="cg_sparse",
                                                **params)
    jx_plan = jx.analyze().codesign(jx_api.CodesignConfig(
        capacity_bytes=4500, overbook=0.25)).lower()
    plan = traced.analyze().codesign(pt_api.CodesignConfig(
        capacity_bytes=4500, overbook=0.25)).lower()
    text = plan.explain()
    assert "pinned=prefix(rows=" in text
    assert "B3 (resident prefix 0/64 rows) for Ax0, Ap0, Ap1, Ap2" in text
    np_feeds = jx_fe.make_feeds(jx.program, seed=3)
    pal = {k: np.asarray(v) for k, v in
           jx_plan.run(np_feeds, backend="pallas").items()}
    feeds = pt_fe.feeds_from_numpy(np_feeds)
    _close(plan.run(feeds), pal, np.float32, "cg_sparse overbooked")
    want = pt_fe.evaluate(traced.program, feeds)
    got = plan.run(feeds, backend="reference")
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _ffn_program(pkg, m=48, d=24, f=40):
    """An LLM FFN phase on the expression frontend: ``ab,bc->ac`` matmuls
    with resident weights, as the JAX package's execution tests build."""
    p = pkg.Program("ffn")
    x = p.input("x", (m, d))
    w_up = p.operator("w_up", (d, f))
    w_gate = p.operator("w_gate", (d, f))
    w_down = p.operator("w_down", (f, d))
    h = p.matmul(x, w_up, name="up")
    g = p.matmul(x, w_gate, name="gate")
    p.output(p.matmul(p.mul(h, g, name="act"), w_down, name="ffn_out"))
    return p


@pytest.mark.parametrize("program", ["ffn", "odd_rows"])
def test_custom_programs_match_pallas(program):
    def build(pkg):
        if program == "ffn":
            return _ffn_program(pkg)
        p = pkg.Program("odd_rows")            # 50 rows: ragged row blocks
        A = p.operator("A", (50, 50), init="spd")
        y = p.matmul(A, p.input("x", (50,)), name="y")
        p.output(p.dot(y, y, name="yy"), p.div(y, p.norm(y, name="ny"),
                                               name="yn"))
        return p
    jx_plan = jx_api.Session.from_graph(build(jx_fe), use_cache=False
                                        ).analyze().codesign().lower()
    pt_plan = pt_api.Session.from_graph(build(pt_fe), device="cpu"
                                        ).analyze().codesign().lower()
    kinds = [u.kind for u in pt_plan.exec_plan.units]
    assert "stream" in kinds
    feeds = jx_fe.make_feeds(jx_plan.trace.program, seed=9)
    pal = {k: np.asarray(v) for k, v in
           jx_plan.run(feeds, backend="pallas").items()}
    got = pt_plan.run(pt_fe.feeds_from_numpy(feeds))
    _close(got, pal, np.float32, program)
