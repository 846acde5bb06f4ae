"""The port's solver serving (``repro_torch.serve``) against the JAX
package's (``repro.serve``), and its own mechanics.

Parity policy:

* **Port against JAX**: the port's ``BatchedPlan`` (the ``cuda`` backend on
  the CPU, i.e. the plain versions of B1, B2 and B4's lane forms, and the
  ``reference`` backend's batched form) against the JAX ``BatchedPlan`` on
  its ``reference`` backend, on identical numpy feeds, within
  ``tests/test_torch_exec.py``'s ``TOL`` (fp32 rtol 2e-4 / atol 1e-5, fp64
  rtol 1e-9 / atol 1e-12; fp64 on the JAX side under
  ``jax.enable_x64(True)``).
* **A lane against its single request** (the port's own unbatched
  ``run()``), per workload in ``LANE_POLICY``: bitwise where the lane form
  keeps the single pass's arithmetic — B2's entry order, B4's sweep, and
  B1's plain lane form reduces and contracts each lane with the single
  pass's own rule (its row blocks, ``mv``) — so cg, power_iteration and the
  three sparse workloads are bitwise; mttkrp's einsum runs under
  ``torch.func.vmap`` as one batched contraction (another BLAS call), so
  it is held to the JAX package's ``SERVE_RTOL`` / ``SERVE_ATOL``
  (``tests/test_serve.py``).  Filler lanes never change real ones.
* **Lane forms against their plain versions**: each lane form's plain
  version equals a loop of the single-request plain version, bitwise.

The server's mechanics are ``tests/test_serve.py``'s classes on the port
(``backend="cuda"`` where the JAX tests used ``pallas``); the JAX
package's disk-cache tests have their twins in
``tests/test_torch_cache.py``.
"""
import ast
import re
import threading
import time

import jax
import numpy as np
import pytest
import torch

import repro.api as jx_api
import repro.frontends as jx_fe
import repro.serve as jx_serve
from repro_torch import kernels
from repro_torch.api import CodesignConfig, ServeConfig, Session
from repro_torch.exec import Executor
from repro_torch.exec.cuda import CudaLaneProgram, lane_names
import repro_torch.frontends as pt_fe
from repro_torch.frontends import (build_workload, evaluate, feeds_from_numpy,
                                  make_feeds)
from repro_torch.kernels import stream
from repro_torch.kernels.spmv import spmv_lanes, spmv_lanes_plain, spmv_plain
from repro_torch.kernels.stencil import stencil2d_lanes, stencil2d_plain
from repro_torch.kernels.stream import (LANE_GROUP, MATRIX_BLOCK_R,
                                        MATVEC_SLICES, LaneStreamKernel,
                                        StreamKernel)
from repro_torch.serve import (BatchedPlan, Overloaded, PlanRouter, Server,
                               ServerClosed, SolveRequest, density_bucket,
                               request)
from repro_torch.testing import faults
from test_torch_stream_wide import generated_on_cpu  # noqa: F401 (fixture)

TOL = {np.float32: dict(rtol=2e-4, atol=1e-5),
       np.float64: dict(rtol=1e-9, atol=1e-12)}
SERVE_TOL = {np.float32: dict(rtol=1e-4, atol=1e-5),
             np.float64: dict(rtol=1e-9, atol=1e-12)}
DTYPES = [np.float32, np.float64]
DT_IDS = ["fp32", "fp64"]

SERVE_SET = [
    ("cg", dict(n=64, iters=3)),
    ("power_iteration", dict(n=64, iters=3)),
    ("cg_sparse", dict(n=64, iters=3)),
    ("cg_sparse", dict(n=64, iters=3, pattern="random", density=0.1)),
    ("bicgstab_sparse", dict(n=64, iters=2)),
    ("jacobi_sparse", dict(n=64, sweeps=3)),
    ("jacobi2d", dict(n=16, sweeps=3)),
    ("mttkrp", dict(i=8, j=8, k=8, rank=4)),
]
SERVE_IDS = ["cg", "power_iteration", "cg_sparse-laplacian5",
             "cg_sparse-density", "bicgstab_sparse", "jacobi_sparse",
             "jacobi2d", "mttkrp"]
#: a lane against its request's unbatched run(), per workload (see the
#: module docstring)
LANE_POLICY = {"cg": "bitwise", "power_iteration": "bitwise",
               "cg_sparse": "bitwise", "bicgstab_sparse": "bitwise",
               "jacobi_sparse": "bitwise", "jacobi2d": "bitwise",
               "mttkrp": "serve_tol"}
N_REQ = 5                      # padded to 8 lanes


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _session():
    return Session(device="cpu")


def _plan(workload, params, **lower):
    traced = _session().trace(workload=workload, **params)
    return traced, traced.codesign().lower(**lower)


def _split(program, seeds, dtype):
    shared = make_feeds(program, seed=0, dtype=dtype,
                        only=[nd.name for nd in program.leaves()
                              if nd.op == "operator"])
    per_req = [make_feeds(program, seed=s, dtype=dtype,
                          only=[nd.name for nd in program.leaves()
                                if nd.op != "operator"]) for s in seeds]
    return shared, per_req


_JAX_OUTS = {}


def _jax_batched(workload, params, dtype):
    """The JAX BatchedPlan's outputs (reference backend) for requests
    0..N_REQ-1, memoized per case (both port backends compare to them)."""
    key = (workload, tuple(sorted(params.items())), dtype)
    if key not in _JAX_OUTS:
        with jax.enable_x64(dtype == np.float64):
            traced = jx_api.Session(use_cache=False).trace(
                workload=workload, **params)
            bp = traced.codesign().lower().batched()
            shared = jx_fe.make_feeds(traced.program, seed=0, dtype=dtype,
                                      only=bp.shared_leaves)
            per_req = [jx_fe.make_feeds(traced.program, seed=s, dtype=dtype,
                                        only=bp.batched_leaves)
                       for s in range(N_REQ)]
            outs = [{k: np.asarray(v) for k, v in o.items()}
                    for o in bp.run_many(per_req, shared)]
        _JAX_OUTS[key] = (shared, per_req, outs)
    return _JAX_OUTS[key]


# ---------------------------------------------------------------------------
# BatchedPlan parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["cuda", "reference"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("workload,params", SERVE_SET, ids=SERVE_IDS)
def test_batched_matches_jax_batched(workload, params, dtype, backend):
    shared, per_req, want = _jax_batched(workload, params, dtype)
    _, plan = _plan(workload, params)
    bp = plan.batched(backend=backend)
    assert bp.backend == backend
    assert sorted(bp.shared_leaves) == sorted(shared)
    got = bp.run_many(per_req, shared)
    assert len(got) == N_REQ
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert _np(g[k]).dtype == w[k].dtype, k
            np.testing.assert_allclose(_np(g[k]), w[k], **TOL[dtype],
                                       err_msg=f"{workload} {k}")


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("workload,params", SERVE_SET, ids=SERVE_IDS)
def test_lane_against_single_request(workload, params, dtype):
    traced, plan = _plan(workload, params)
    bp = plan.batched()
    shared, per_req = _split(traced.program, range(N_REQ), dtype)
    outs = bp.run_many(per_req, shared)
    for r, out in zip(per_req, outs):
        one = bp.run_one({**shared, **r})
        assert sorted(one) == sorted(out)
        for k in one:
            if LANE_POLICY[workload] == "bitwise":
                assert torch.equal(out[k], one[k]), (workload, k)
            else:
                np.testing.assert_allclose(_np(out[k]), _np(one[k]),
                                           **SERVE_TOL[dtype])


@pytest.mark.parametrize("workload,params", SERVE_SET, ids=SERVE_IDS)
def test_filler_lanes_never_change_real_ones(workload, params):
    traced, plan = _plan(workload, params)
    bp = plan.batched()
    shared, per_req = _split(traced.program, range(3), np.float32)
    junk = {n: np.full_like(v, 1e30) for n, v in per_req[0].items()}
    feeds = dict(shared)
    for n in bp.batched_leaves:
        feeds[n] = np.stack([r[n] for r in per_req] + [junk[n]])
    with_junk = bp.run_batch(feeds)
    padded = bp.run_many(per_req, shared)               # 3 -> 4 lanes
    unpadded = bp.run_many(per_req, shared, pad=False)
    for i in range(3):
        for k in with_junk:
            assert torch.equal(with_junk[k][i], unpadded[i][k]), k
            assert torch.equal(padded[i][k], unpadded[i][k]), k


def test_fp64_serving_against_jax_evaluate():
    """fp64 through the port's Server, held against the JAX package's
    ``evaluate`` under x64 (its own fp64 Server path cannot run on the
    installed JAX)."""
    srv = Server(PlanRouter(_session()), ServeConfig(max_batch_size=4,
                                                     autostart=False))
    futs = [srv.submit(request("cg_sparse", n=64, iters=3, seed=s,
                               dtype="float64", backend="cuda"))
            for s in range(3)]
    srv.start()
    res = [f.result(timeout=60) for f in futs]
    srv.close()
    prog = jx_fe.build_workload("cg_sparse", n=64, iters=3)
    for s, r in enumerate(res):
        feeds = {**jx_fe.make_feeds(prog, seed=0, dtype=np.float64,
                                    only=["A.indptr", "A.indices",
                                          "A.data"]),
                 **jx_fe.make_feeds(prog, seed=s, dtype=np.float64,
                                    only=["b", "x0"])}
        with jax.enable_x64(True):
            want = {k: np.asarray(v)
                    for k, v in jx_fe.evaluate(prog, feeds).items()}
        for k in want:
            assert _np(r.outputs[k]).dtype == np.float64
            np.testing.assert_allclose(_np(r.outputs[k]), want[k],
                                       **TOL[np.float64])


def test_fp32_cg_at_the_served_size_breaks_down_by_64_iterations():
    """Why the served fp32 cg(n=4096) bucket runs 32 iterations, not 64:
    on that operator fp32 CG drives ``rs`` below the smallest float32, so
    ``beta = 0/0`` and ``x`` turns NaN.  The JAX reference does so for
    every seed (XLA flushes denormals: ``rs`` hits 0 near iteration 47),
    the port's reference for some (it keeps them: seed 6 hits 0 near 57);
    at 32 both are finite."""
    prog = jx_fe.build_workload("cg", n=4096, iters=64)
    tprog = build_workload("cg", n=4096, iters=64)
    A = jx_fe.make_feeds(prog, seed=0, dtype=np.float32, only=["A"])
    for seed in (0, 6):
        feeds = {**A, **jx_fe.make_feeds(prog, seed=seed, dtype=np.float32,
                                         only=["b", "x0"])}
        want = jx_fe.evaluate(prog, feeds, return_all=True)
        assert not np.isfinite(np.asarray(want["x64"])).all(), seed
        assert float(want["rs32"]) > 0.0
        assert np.isfinite(np.asarray(want["x32"])).all()
        got = evaluate(tprog, feeds_from_numpy(feeds), return_all=True)
        assert float(got["rs32"]) > 0.0
        assert torch.isfinite(got["x32"]).all()
        if seed == 6:
            assert not torch.isfinite(got["x64"]).all()


# ---------------------------------------------------------------------------
# the lane forms against loops of their single-request plain versions
# ---------------------------------------------------------------------------

B1_SET = [("cg", dict(n=64, iters=2)), ("power_iteration", dict(n=64,
                                                                iters=2)),
          ("gmres", dict(n=64, restart=2)),
          ("bicgstab_sparse", dict(n=64, iters=2)),
          ("jacobi_sparse", dict(n=64, sweeps=2))]


def _passes(workload, params):
    """(single pass, lane pass, lane names) for every B1 pass of a plan."""
    _, plan = _plan(workload, params)
    prog = plan.trace.program
    lanes = lane_names(prog)
    for u in plan.exec_plan.units:
        nodes = [prog.nodes[o] for o in u.ops if prog.nodes[o].op != "spmv"]
        if u.kind != "stream" or not nodes:
            continue
        shapes = {n: prog.nodes[n].shape
                  for nd in nodes for n in (*nd.inputs, nd.name)}
        needed = {nd.name for nd in nodes}
        yield (StreamKernel(nodes, shapes, needed, u.sp.rows),
               LaneStreamKernel(nodes, shapes, needed, u.sp.rows, lanes),
               lanes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=DT_IDS)
@pytest.mark.parametrize("workload,params", B1_SET,
                         ids=[w for w, _ in B1_SET])
def test_b1_lanes_plain_is_a_loop_of_the_single_plain(workload, params,
                                                      dtype):
    rng = np.random.default_rng(4)
    n_lanes, seen = 5, 0
    for k1, kl, lanes in _passes(workload, params):
        env = {}
        for n in kl.in_names:
            shape = (n_lanes, *k1.shapes[n]) if n in lanes \
                else tuple(k1.shapes[n])
            env[n] = torch.from_numpy(rng.standard_normal(shape) + 2.0
                                      ).to(dtype)
        out = kl(env)
        for i in range(n_lanes):
            one = k1.plain({n: env[n][i] if n in lanes else env[n]
                            for n in k1.in_names})
            for n in one:
                assert torch.equal(out[n][i], one[n]), (workload, n)
        seen += 1
    assert seen


@pytest.mark.parametrize("n_lanes", [1, 5, 17])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=DT_IDS)
@pytest.mark.parametrize("workload,params", B1_SET,
                         ids=[w for w, _ in B1_SET])
def test_b1_generated_lane_pass_is_the_single_pass_per_lane(
        workload, params, dtype, n_lanes, generated_on_cpu):
    """Every lane pass's generated kernels, run through the numpy
    stand-in for Triton (``tests/test_torch_stream_wide.py``), give each
    lane bitwise what the single-request generated pass gives on that lane
    alone: at 1 lane, 5, and 17 (a second, ragged group of a
    ``LANE_GROUP`` pass).  The dense workloads run at n = 200, so that a
    matvec slice adds several products over several K steps (at n = 64
    its two terms would add alike in either order)."""
    rng = np.random.default_rng(8)
    seen = 0
    if workload in ("cg", "power_iteration", "gmres"):
        params = {**params, "n": 200}
    for k1, kl, lanes in _passes(workload, params):
        env = {}
        for n in kl.in_names:
            shape = (n_lanes, *k1.shapes[n]) if n in lanes \
                else tuple(k1.shapes[n])
            env[n] = torch.from_numpy(rng.standard_normal(shape) + 2.0
                                      ).to(dtype)
        out = kl(env)
        for i in range(n_lanes):
            one = k1({n: env[n][i] if n in lanes else env[n]
                      for n in k1.in_names})
            assert sorted(one) == sorted(out)
            for n in one:
                assert torch.equal(out[n][i], one[n]), (workload, n, i)
        seen += 1
    assert seen


@pytest.mark.parametrize("n_lanes", [1, 17])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=DT_IDS)
def test_b1_lane_group_broadcasts_like_the_single_pass(dtype, n_lanes,
                                                       generated_on_cpu):
    """A lane group's (rows, lanes) tiles mix a lane scalar dividing a
    tile, a shared vector and a lane vector, a norm and an eager scalar
    op (none of ``B1_SET``'s passes does): through the numpy stand-in for
    Triton every lane is bitwise the single-request pass on it alone."""
    p = pt_fe.Program("mix")
    A = p.operator("A", (48, 48))
    d = p.operator("d", (48,))
    x, s = p.input("x", (48,)), p.input("s", ())
    y = p.div(p.matmul(A, x, name="y"), s, name="ys")
    z = p.add(p.mul(y, d, name="yd"), p.div(d, s, name="ds"), name="z")
    p.output(z, p.norm(z, name="nz"), p.neg(s, name="ns"))
    nodes = [p.nodes[n] for n in ("y", "ys", "yd", "ds", "z", "nz", "ns")]
    shapes = {n: p.nodes[n].shape for nd in nodes
              for n in (*nd.inputs, nd.name)}
    needed = {nd.name for nd in nodes}
    k1 = StreamKernel(nodes, shapes, needed, 48)
    kl = LaneStreamKernel(nodes, shapes, needed, 48, {"x", "s"})
    assert kl.group == LANE_GROUP
    rng = np.random.default_rng(9)
    env = {"A": rng.standard_normal((48, 48)), "d": rng.standard_normal(48),
           "x": rng.standard_normal((n_lanes, 48)),
           "s": rng.uniform(0.5, 1.5, n_lanes)}
    env = {n: torch.from_numpy(v).to(dtype) for n, v in env.items()}
    with np.errstate(divide="ignore", invalid="ignore"):   # filler lanes
        out = kl(env)
    for i in range(n_lanes):
        one = k1({n: env[n][i] if n in ("x", "s") else env[n]
                  for n in k1.in_names})
        assert sorted(one) == sorted(out)
        for n in one:
            assert torch.equal(out[n][i], one[n]), (n, i)


#: small sizes of every registered workload, for planning on the CPU
SMALL = {"mttkrp": dict(i=32, j=32, k=32, rank=16)}


@pytest.mark.parametrize("workload", pt_fe.list_workloads())
def test_b1_lane_pass_reads_a_shared_stream_once_a_group(workload):
    """Every lane pass that a registered workload's plan holds and that
    streams an operand without lanes (cg's ``A``, jacobi_sparse's
    ``A.dinv``) runs ``LANE_GROUP`` lanes a program, so each tile of that
    operand is read once for the group; every other lane pass runs one
    lane a program."""
    for _k1, kl, _lanes in _passes(workload, SMALL.get(workload,
                                                        dict(n=256))):
        shared = [t for t in kl.stream_in if t not in kl.lanes]
        assert kl.group == (LANE_GROUP if shared else 1), (
            workload, kl.out_names, shared, kl.group)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=DT_IDS)
@pytest.mark.parametrize("pattern,kw", [
    ("laplacian5", {}), ("banded", dict(bandwidth=4)),
    ("random", dict(density=0.15)), ("skewed", dict(density=0.2))])
def test_b2_lanes_plain_is_a_loop_of_b2_plain(pattern, kw, dtype):
    p = jx_fe.Program("spmv")
    A = p.sparse_operator("A", (64, 64), pattern=pattern, **kw)
    p.output(p.spmv(A, p.input("x", (64,)), name="y"))
    f = feeds_from_numpy(jx_fe.make_feeds(p, seed=6))
    csr = [f[f"A.{c}"] for c in ("indptr", "indices", "data")]
    csr[2] = csr[2].to(dtype)
    X = torch.from_numpy(np.random.default_rng(2).standard_normal((5, 64))
                         ).to(dtype)
    Y = spmv_lanes(*csr, X, 64)
    assert Y.shape == (5, 64)
    for i in range(5):
        assert torch.equal(Y[i], spmv_plain(*csr, X[i], 64))
        assert torch.equal(Y[i], spmv_lanes_plain(*csr, X[i:i + 1], 64)[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=DT_IDS)
@pytest.mark.parametrize("f_lanes", [True, False, None],
                         ids=["f-lanes", "f-shared", "no-f"])
def test_b4_lanes_plain_is_a_loop_of_b4_plain(f_lanes, dtype):
    rng = np.random.default_rng(3)
    U = torch.from_numpy(rng.standard_normal((4, 13, 17))).to(dtype)
    F = (None if f_lanes is None else torch.from_numpy(
        rng.standard_normal((4, 13, 17) if f_lanes else (13, 17))).to(dtype))
    out = stencil2d_lanes(U, F, 0.7, lanes=4)
    for i in range(4):
        f = None if F is None else (F[i] if f_lanes else F)
        assert torch.equal(out[i], stencil2d_plain(U[i], f, 0.7))


def test_b4_lanes_with_a_shared_grid():
    """A lane-independent u with lane-dependent f still gives every lane."""
    u = torch.randn(8, 8, dtype=torch.float64)
    F = torch.randn(3, 8, 8, dtype=torch.float64)
    out = stencil2d_lanes(u, F, 1.0, lanes=3)
    for i in range(3):
        assert torch.equal(out[i], stencil2d_plain(u, F[i], 1.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=DT_IDS)
def test_lane_source_is_the_single_body_per_lane(dtype):
    """The generated lane kernels parse, take the lane count as a plain
    argument (one compile for every count), carry ``LANE_GROUP`` lanes a
    program where the pass streams an operand without lanes (each of its
    tiles then loaded once), one lane a program otherwise, and leave the
    single-request source as it was.  A group's kernel has no branch
    (lanes past ``L`` are masked): its streamed matvec accumulates a rows
    x lanes x ``MATVEC_SLICES`` tile where the single pass has rows x
    ``MATVEC_SLICES``, both folding the slices with the same text, and
    each of its reductions folds the rows with the single pass's tree,
    all lanes at once."""
    seen = {1: 0, LANE_GROUP: 0}
    tdt = "tl.float32" if dtype == torch.float32 else "tl.float64"
    r, sl = MATRIX_BLOCK_R, MATVEC_SLICES
    for wl, params in B1_SET:
        for k1, kl, lanes in _passes(wl, params):
            src = kl.source(dtype)
            single = k1.source(dtype)
            tree = ast.parse(src)
            main, fin = [f for f in tree.body
                         if isinstance(f, ast.FunctionDef)]
            assert [a.arg for a in main.args.args][-1] == "L"
            assert [a.arg for a in fin.args.args][-1] == "L"
            assert src.count('@triton.jit(do_not_specialize=["L"])') == 2
            shared_stream = [t for t in kl.stream_in if t not in kl.lanes]
            assert kl.group == (LANE_GROUP if shared_stream else 1)
            seen[kl.group] += 1
            group = (kl.group,) if kl.group > 1 else ()
            lines = {ln.strip() for ln in src.splitlines()}
            single_lines = {ln.strip() for ln in single.splitlines()}
            if kl.group > 1:
                assert not [f for f in ast.walk(main)
                            if isinstance(f, ast.If)]
                for t in shared_stream:       # one load of it a program
                    assert src.count(f"p_v{kl.in_names.index(t)} + ") == 1 \
                        or "for k0" in src
                reds = re.findall(r"(v\d+)_t = tl.where", single)
                assert len(reds) == len(kl.red_out)
                for v in reds:                # the single pass's row tree
                    assert set(stream._fold(f"{v}_t", (), r, f"{v}_t")) <= \
                        single_lines
                    assert set(stream._fold(f"{v}_t", group, r,
                                            f"{v}_t")) <= lines
            loops = [f for f in ast.walk(main) if isinstance(f, ast.For)]
            if loops:                         # a streamed matvec
                (loop,) = loops
                assert not [f for f in ast.walk(loop)
                            if isinstance(f, ast.If)]
                acc = re.search(r"(v\d+)_s = tl.zeros", single).group(1)
                zeros = ", ".join(map(str, (r, *group, sl)))
                assert f"{acc}_s = tl.zeros(({zeros}), dtype={tdt})" in src
                assert set(stream._fold(f"{acc}_s", (r, *group), sl,
                                        acc)) <= lines
                assert set(stream._fold(f"{acc}_s", (r,), sl, acc)) <= \
                    single_lines
            assert kl.source(dtype) == src
            assert "L" not in [a.arg for a in ast.parse(single)
                               .body[2].args.args]
    assert seen[1] and seen[LANE_GROUP]


def test_lane_pass_refuses_a_lane_independent_node():
    p = jx_fe.Program("p")
    A = p.operator("A", (8, 8))
    w = p.operator("w", (8,))
    x = p.input("x", (8,))
    y = p.matmul(A, w, name="y")              # no input carries lanes
    p.output(p.add(y, x, name="z"))
    nodes = [p.nodes["y"], p.nodes["z"]]
    shapes = {n: p.nodes[n].shape for n in p.nodes}
    with pytest.raises(ValueError, match="runs once"):
        LaneStreamKernel(nodes, shapes, {"z"}, 8, {"x", "z"})


# ---------------------------------------------------------------------------
# the lane-batched program
# ---------------------------------------------------------------------------

def test_lane_names_follow_the_inputs():
    traced, _ = _plan("jacobi_sparse", dict(n=64, sweeps=2))
    lanes = lane_names(traced.program)
    assert {"b", "x0", "Ax0", "x2"} <= lanes
    assert not lanes & {"A.indptr", "A.indices", "A.data", "A.dinv"}


def test_lane_program_computes_shared_nodes_once():
    """A node computed from operator leaves alone runs once, single-request
    sized, and an output without lanes is every lane's."""
    from repro_torch.frontends.expr import Program
    p = Program("shared")
    A = p.operator("A", (16, 16))
    w = p.operator("w", (16,))
    x = p.input("x", (16,))
    aw = p.matmul(A, w, name="aw")            # lane-independent
    p.output(p.add(aw, x, name="z"), aw)
    plan = Session.from_graph(p, device="cpu").codesign().lower()
    prog = CudaLaneProgram(plan)
    assert prog.lanes == {"x", "z"}
    f = make_feeds(p, seed=0)
    X = np.stack([make_feeds(p, seed=s)["x"] for s in range(3)])
    with kernels.counting():
        out = prog({"A": f["A"], "w": f["w"]}, {"x": X})
    assert out["aw"].shape == (3, 16) and out["z"].shape == (3, 16)
    one = plan.run({**f, "x": X[1]})
    assert torch.equal(out["z"][1], one["z"])
    assert torch.equal(out["aw"][2], one["aw"])


def test_cuda_lane_program_stats_one_signature_per_lanes_and_dtype():
    traced, plan = _plan("cg", dict(n=32, iters=2))
    bp = plan.batched()
    assert isinstance(bp._batched, CudaLaneProgram)
    for dtype in (np.float32, np.float64):
        shared, per_req = _split(traced.program, range(8), dtype)
        bp.run_many(per_req, shared)
        bp.run_many(per_req[:5], shared)      # padded to 8 again
        bp.run_many(per_req[:3], shared)      # 4 lanes
    assert bp.stats == {"traces": 4, "dispatches": 6}
    st = bp.program_stats
    assert (st["traces"], st["dispatches"], st["runs"]) == (4, 6, 6)


def test_perunit_backend_walks_the_lane_units():
    traced, plan = _plan("bicgstab_sparse", dict(n=64, iters=2))
    shared, per_req = _split(traced.program, range(3), np.float32)
    got = plan.batched(backend="cuda-perunit").run_many(per_req, shared)
    want = plan.batched(backend="cuda").run_many(per_req, shared)
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(_np(g[k]), _np(w[k]),
                                       **TOL[np.float32])


def test_default_compile_batched_loops_over_lanes():
    class Counting(Executor):
        name = "counting-batched"

        def compile(self, p):
            from repro_torch.exec.reference import execute_plan
            return lambda f: execute_plan(p.trace.program, feeds=f)

    traced, plan = _plan("cg", dict(n=32, iters=2))
    bp = BatchedPlan(plan, backend=Counting())
    shared, per_req = _split(traced.program, range(3), np.float32)
    got = bp.run_many(per_req, shared, pad=False)
    for g, r in zip(got, per_req):
        want = plan.run({**shared, **r}, backend="reference")
        for k in want:
            assert torch.equal(g[k], want[k])


@pytest.mark.parametrize("backend", ["cuda", "cuda-perunit"])
def test_overbooked_plan_has_no_lane_form_yet(backend):
    # tests/test_torch_overbook.py's "cg_n4096_tiles" case: a prefix pin
    # that the arrangement accepts, so its spmv ops run on B3
    traced = Session(device="cpu").trace(workload="cg_sparse", n=4096,
                                         iters=2, pattern="banded",
                                         bandwidth=16)
    plan = traced.codesign(CodesignConfig(capacity_bytes=1317278,
                                          overbook=0.25)).lower()
    from repro_torch.exec.cuda import spmv_prefixes
    prog = plan.trace.program
    assert any(k is not None
               for u in plan.exec_plan.units if u.kind == "stream"
               for k in spmv_prefixes(prog, u.sp).values())
    # the gap this test once asserted is closed: the plan batches on B3's
    # lane form, and each lane equals the reference's and its own run()
    bp = plan.batched(backend=backend)
    assert bp.backend == backend
    shared, per_req = _split(prog, range(3), np.float32)
    got = bp.run_many(per_req, shared)
    want = plan.batched(backend="reference").run_many(per_req, shared)
    for g, w, r in zip(got, want, per_req):
        one = plan.run({**shared, **r})
        for k in w:
            np.testing.assert_allclose(_np(g[k]), _np(w[k]),
                                       **TOL[np.float32], err_msg=k)
            assert torch.equal(g[k], one[k]), k


# ---------------------------------------------------------------------------
# BatchedPlan mechanics (tests/test_serve.py::TestBatchedPlanMechanics)
# ---------------------------------------------------------------------------

class TestBatchedPlanMechanics:
    def test_one_dispatch_per_batch_and_trace_reuse(self):
        traced, plan = _plan("cg", dict(n=64, iters=2))
        bp = plan.batched()
        shared, per_req = _split(traced.program, range(8), np.float32)
        bp.run_many(per_req, shared)
        assert bp.stats == {"traces": 1, "dispatches": 1}
        bp.run_many(per_req, shared)
        assert bp.stats == {"traces": 1, "dispatches": 2}
        bp.run_many(per_req[:4], shared)
        assert bp.stats == {"traces": 2, "dispatches": 3}

    def test_shape_validation(self):
        traced, plan = _plan("cg", dict(n=64, iters=2))
        bp = plan.batched()
        shared, per_req = _split(traced.program, range(2), np.float32)
        feeds = dict(shared)
        for n in bp.batched_leaves:
            feeds[n] = np.stack([r[n] for r in per_req])
        with pytest.raises(ValueError, match="unbatched"):
            bp.run_batch({**feeds, "A": np.stack([shared["A"]] * 2)})
        with pytest.raises(ValueError, match="must be batched"):
            bp.run_batch({**feeds, "b": per_req[0]["b"]})
        with pytest.raises(ValueError, match="inconsistent batch"):
            bp.run_batch({**feeds, "x0": np.stack([per_req[0]["x0"]] * 3)})
        bad = dict(feeds)
        del bad["b"]
        with pytest.raises(KeyError, match="missing leaf"):
            bp.run_batch(bad)

    def test_batched_convenience_and_leaf_split(self):
        _, plan = _plan("cg_sparse", dict(n=64, iters=2))
        bp = plan.batched()
        assert isinstance(bp, BatchedPlan) and bp.backend == "cuda"
        assert set(bp.batched_leaves) == {"b", "x0"}
        assert all(n.startswith("A.") for n in bp.shared_leaves)
        from repro_torch.api import ExecConfig
        assert plan.batched(ExecConfig(backend="reference")).backend == \
            "reference"
        with pytest.raises(TypeError, match="not both"):
            plan.batched(ExecConfig(backend="cuda"), backend="reference")

    def test_tensor_requests_stack_on_the_device(self):
        traced, plan = _plan("cg", dict(n=32, iters=2))
        bp = plan.batched()
        shared, per_req = _split(traced.program, range(3), np.float32)
        as_t = [feeds_from_numpy(r) for r in per_req]
        got = bp.run_many(as_t, feeds_from_numpy(shared))
        want = bp.run_many(per_req, shared)
        for g, w in zip(got, want):
            for k in w:
                assert torch.equal(g[k], w[k])


# ---------------------------------------------------------------------------
# router: bucket keys equal the JAX package's, LRU
# ---------------------------------------------------------------------------

ROUTED = [dict(workload="cg", n=64), dict(workload="cg", n=64, iters=4),
          dict(workload="cg_sparse", n=64),
          dict(workload="cg_sparse", n=64, pattern="laplacian5", iters=4),
          dict(workload="cg_sparse", n=64, pattern="random", density=0.0012),
          dict(workload="cg_sparse", n=64, pattern="banded", bandwidth=3),
          dict(workload="jacobi2d", n=16, dtype="float64"),
          dict(workload="mttkrp", i=8, j=8, k=8, rank=4, backend="cuda"),
          dict(workload="jacobi_sparse", n=64, pattern="skewed",
               density=0.05, dtype="float64", backend="cuda")]


@pytest.mark.parametrize("spec", ROUTED, ids=range(len(ROUTED)))
def test_bucket_labels_equal_the_jax_packages(spec):
    spec = dict(spec)
    wl = spec.pop("workload")
    ours = request(wl, **spec).bucket()
    theirs = jx_serve.request(wl, **spec).bucket()
    assert ours.label == theirs.label
    assert (ours.workload, ours.params, ours.dtype, ours.density,
            ours.backend) == (theirs.workload, theirs.params, theirs.dtype,
                              theirs.density, theirs.backend)


def test_lru_hits_misses_evictions_match_the_jax_router():
    pt = PlanRouter(session=_session(), max_plans=2)
    jx = jx_serve.PlanRouter(session=jx_api.Session(use_cache=False),
                             max_plans=2)
    seq = [32, 32, 48, 64, 32, 64]
    for n in seq:
        pt.plan_for(pt.bucket(request("cg", n=n, iters=2)))
        jx.plan_for(jx.bucket(jx_serve.request("cg", n=n, iters=2)))
    assert pt.stats() == jx.stats()
    assert pt.stats()["evictions"] == 2


class TestRouter:
    def test_density_decade_bucketing(self):
        ks = [request("cg_sparse", n=64, pattern="random",
                      density=d).bucket() for d in (0.0008, 0.001, 0.0012)]
        assert len(set(ks)) == 1
        assert dict(ks[0].params)["density"] == 0.001
        assert request("cg_sparse", n=64, pattern="random",
                       density=0.01).bucket() != ks[0]
        assert density_bucket(0.5) == 1.0
        for bad in (0.0, -1.0, 1.5):
            with pytest.raises(ValueError):
                density_bucket(bad)

    def test_invalid_requests_raise(self):
        with pytest.raises(KeyError, match="unknown HPC workload"):
            request("nope").bucket()
        with pytest.raises(TypeError):
            request("cg", n=64, bogus=1).bucket()
        with pytest.raises(ValueError, match="float dtype"):
            request("cg", n=64, dtype="int32")

    def test_shared_operator_uploaded_once_per_bucket(self, tmp_path,
                                                      monkeypatch):
        monkeypatch.delenv("CELLO_NO_CACHE", raising=False)
        r = PlanRouter(session=Session(device="cpu", cache_dir=tmp_path))
        key = request("cg", n=32, iters=2, backend="cuda").bucket()
        entry = r.plan_for(key)
        assert all(isinstance(v, torch.Tensor)
                   for v in entry.shared_feeds.values())
        assert r.plan_for(key).shared_feeds["A"] is entry.shared_feeds["A"]
        # the fallback variant reuses the bucket's codesign, replayed from
        # the session's disk cache
        fb = r.plan_for(request("cg", n=32, iters=2).bucket())
        first = entry.bplan.plan.codesigned
        assert not first.from_cache and fb.bplan.plan.codesigned.from_cache
        assert fb.bplan.plan.codesigned.best.schedule == first.best.schedule

    def test_bucket_plan_reads_its_bound_operator(self):
        r = PlanRouter(session=_session())
        entry = r.plan_for(request("cg", n=32, iters=2,
                                   backend="cuda").bucket())
        req = r.request_feeds(entry, request("cg", n=32, iters=2, seed=1,
                                             backend="cuda"))
        copy = {k: v.clone() for k, v in entry.shared_feeds.items()}
        with pytest.raises(ValueError, match="bound"):
            entry.bplan.run_many([req], copy)
        # a write to the bound operator shows in the next dispatch
        entry.shared_feeds["A"].data.mul_(2.0)
        got = entry.bplan.run_many([req], entry.shared_feeds)[0]
        want = entry.bplan.run_one({"A": 2.0 * copy["A"], **req})
        for k in want:
            assert torch.equal(got[k], want[k]), k

    def test_request_feeds_overlay(self):
        r = PlanRouter(session=_session())
        entry = r.plan_for(request("cg", n=64, iters=2).bucket())
        b = np.ones(64, np.float64)
        feeds = r.request_feeds(entry, request("cg", n=64, iters=2,
                                               feeds={"b": b}))
        assert feeds["b"].dtype == np.float32
        np.testing.assert_array_equal(feeds["b"], np.ones(64, np.float32))
        with pytest.raises(KeyError, match="shared operator"):
            r.request_feeds(entry, request(
                "cg", n=64, iters=2,
                feeds={"A": np.eye(64, dtype=np.float32)}))
        with pytest.raises(ValueError, match="expected shape"):
            r.request_feeds(entry, request("cg", n=64, iters=2,
                                           feeds={"b": np.ones(5)}))


# ---------------------------------------------------------------------------
# server: coalescing, one dispatch per batch, stats, errors
# ---------------------------------------------------------------------------

def _server(**cfg):
    return Server(PlanRouter(_session()), ServeConfig(**cfg))


def _reconciles(st):
    served = sum(size * cnt for b in st["buckets"].values()
                 for size, cnt in b["batch_sizes"].items())
    return st["requests"] == (st["queue_depth"] + st["in_flight"]
                              + st["errors"] + served), served


class TestServer:
    def test_smoke_32_mixed_buckets_one_dispatch_per_batch(self):
        srv = _server(max_batch_size=16, autostart=False)
        futs = []
        for s in range(16):
            futs.append(srv.submit(request("cg", n=64, iters=2, seed=s,
                                           backend="cuda")))
            futs.append(srv.submit(request("cg_sparse", n=64, iters=2,
                                           seed=s, backend="cuda")))
        srv.start()
        results = [f.result(timeout=120) for f in futs]
        srv.close()
        assert all(r.batch_size == 16 and r.backend == "cuda"
                   for r in results)
        assert all(np.isfinite(r.residual) for r in results)
        st = srv.stats()
        assert (st["requests"], st["batches"], st["queue_depth"],
                st["plans_cached"]) == (32, 2, 0, 2)
        for b in st["buckets"].values():
            assert b["requests"] == 16 and b["batches"] == 1
            assert b["dispatches"] == b["batches"] == 1
            assert b["traces"] == 1 and b["batch_sizes"] == {16: 1}
            assert b["cache_misses"] == 1

    def test_coalescing_32_into_ceil_32_over_16_batches(self):
        srv = _server(max_batch_size=16, autostart=False)
        futs = [srv.submit(request("cg", n=32, iters=2, seed=s,
                                   backend="cuda")) for s in range(32)]
        srv.start()
        assert [f.result(timeout=120).batch_size for f in futs] == [16] * 32
        srv.close()
        (b,) = srv.stats()["buckets"].values()
        assert b["batches"] == -(-32 // 16) == b["dispatches"]

    def test_max_batch_size_splits_bursts(self):
        srv = _server(max_batch_size=8, autostart=False)
        futs = [srv.submit(request("cg", n=64, iters=2, seed=s))
                for s in range(20)]
        srv.start()
        sizes = sorted(f.result(timeout=120).batch_size for f in futs)
        srv.close()
        assert sizes == [4] * 4 + [8] * 16
        (bucket,) = srv.stats()["buckets"].values()
        assert bucket["batches"] == bucket["dispatches"] == 3
        assert bucket["batch_sizes"] == {8: 2, 4: 1}

    def test_max_wait_coalesces_trickle(self):
        srv = _server(max_batch_size=16, max_wait_us=500_000)
        futs = [srv.submit(request("cg", n=64, iters=2, seed=s))
                for s in range(4)]
        results = [f.result(timeout=120) for f in futs]
        srv.close()
        assert [r.batch_size for r in results] == [4, 4, 4, 4]
        (bucket,) = srv.stats()["buckets"].values()
        assert bucket["batches"] == 1

    def test_round_robin_no_starvation(self):
        srv = _server(max_batch_size=2, max_wait_us=0, autostart=False,
                      policy="round_robin")
        order, lock = [], threading.Lock()

        def tag(label):
            def cb(_f):
                with lock:
                    order.append(label)
            return cb

        futs = []
        for label, n in (("h1", 64), ("h2", 128)):
            for s in range(6):
                f = srv.submit(request("cg", n=n, iters=2, seed=s))
                f.add_done_callback(tag(label))
                futs.append(f)
        cold = srv.submit(request("cg_sparse", n=64, iters=2))
        cold.add_done_callback(tag("cold"))
        futs.append(cold)
        srv.start()
        assert all(np.isfinite(f.result(timeout=120).residual)
                   for f in futs)
        srv.close()
        assert order.index("cold") <= 4, order
        assert {"h1", "h2", "cold"} <= set(order[:5]), order

    def test_policy_and_config_validation(self):
        with pytest.raises(ValueError, match="unknown policy"):
            _server(autostart=False, policy="fifo")
        with pytest.raises(ValueError, match="unknown overload"):
            _server(autostart=False, overload="drop")
        with pytest.raises(TypeError, match="ServeConfig"):
            Server(PlanRouter(_session()), config={"max_batch_size": 4})
        with pytest.raises(TypeError, match="two configs"):
            Server(ServeConfig(), config=ServeConfig())

    def test_execution_error_propagates_to_futures(self):
        router = PlanRouter(_session())
        srv = Server(router, ServeConfig(autostart=False))
        bad = srv.submit(request("cg", n=64, iters=2,
                                 feeds={"b": np.ones(3)}))
        ok = srv.submit(request("cg", n=64, iters=2, seed=1))
        srv.start()
        with pytest.raises(ValueError, match="expected shape"):
            bad.result(timeout=120)
        with pytest.raises(ValueError):
            ok.result(timeout=120)            # same batch: shares it
        srv.close()
        after = Server(router)
        assert np.isfinite(after.solve(request("cg", n=64, iters=2,
                                               seed=1)).residual)
        after.close()

    def test_submit_side_validation_and_close(self):
        srv = _server(autostart=False)
        with pytest.raises(KeyError):
            srv.submit(request("nope"))
        with pytest.raises(TypeError, match="SolveRequest"):
            srv.submit({"workload": "cg", "n": 32})
        pending = srv.submit(request("cg", n=64, iters=2))
        srv.close(flush=False)
        with pytest.raises(RuntimeError, match="closed"):
            pending.result(timeout=10)
        with pytest.raises(ServerClosed, match="closed"):
            srv.submit(request("cg", n=64, iters=2))

    def test_context_manager_solves(self):
        with Server(PlanRouter(_session())) as srv:
            res = srv.solve(request("cg_sparse", n=64, iters=2, seed=3,
                                    backend="cuda"))
        assert res.batch_size == 1 and "cg_sparse" in res.bucket
        assert set(res.outputs) == {"x2", "r2"}
        assert res.residual == pytest.approx(
            float(np.linalg.norm(_np(res.outputs["r2"]))), rel=1e-6)


class TestConcurrency:
    def test_executor_compiles_once_under_race(self):
        traced, plan = _plan("cg", dict(n=32, iters=2))
        feeds = make_feeds(traced.program, seed=0)
        compiles = []

        class Counting(Executor):
            name = "counting-serve-test"

            def compile(self, p):
                compiles.append(threading.get_ident())
                time.sleep(0.05)
                from repro_torch.exec.reference import execute_plan
                return lambda f: execute_plan(p.trace.program, feeds=f)

        ex = Counting()
        barrier = threading.Barrier(6)

        def run():
            barrier.wait()
            ex.run(plan, feeds)

        threads = [threading.Thread(target=run) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(compiles) == 1

    def test_session_trace_memo_race(self):
        sess = _session()
        barrier = threading.Barrier(8)
        got = []

        def tracer():
            barrier.wait()
            got.append(sess.trace(workload="cg", n=48, iters=2))

        threads = [threading.Thread(target=tracer) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(got) == 8 and all(g is got[0] for g in got)

    def test_client_threads_run_plans_while_the_worker_serves(self):
        """The worker captures and replays a bucket's lane program while
        client threads run another program of the same plan."""
        srv = _server(max_batch_size=4, max_wait_us=1000)
        traced, plan = _plan("cg", dict(n=32, iters=2))
        feeds = make_feeds(traced.program, seed=2)
        want = plan.run(feeds)
        errors = []

        def client():
            try:
                for _ in range(5):
                    got = plan.run(feeds)
                    for k in want:
                        assert torch.equal(got[k], want[k])
            except Exception as e:          # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=client) for _ in range(3)]
        futs = [srv.submit(request("cg", n=32, iters=2, seed=s,
                                   backend="cuda")) for s in range(8)]
        for t in threads:
            t.start()
        assert all(np.isfinite(f.result(timeout=120).residual)
                   for f in futs)
        for t in threads:
            t.join()
        srv.close()
        assert not errors, errors


class TestServerObservability:
    def test_concurrent_submit_totals_reconcile(self):
        srv = _server(max_batch_size=8, max_wait_us=2000.0)
        n_threads, per = 4, 10
        futs, flock = [], threading.Lock()

        def client(t):
            for i in range(per):
                f = srv.submit(request("cg", n=64, iters=2,
                                       seed=t * per + i))
                with flock:
                    futs.append(f)

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for _ in range(10):
            assert _reconciles(srv.stats())[0]
            time.sleep(0.002)
        for th in threads:
            th.join()
        results = [f.result(timeout=120) for f in futs]
        srv.close()
        st = srv.stats()
        total = n_threads * per
        assert st["requests"] == total and st["errors"] == 0
        assert st["queue_depth"] == 0 and st["in_flight"] == 0
        ok, served = _reconciles(st)
        assert ok and served == total
        (bucket,) = st["buckets"].values()
        assert st["batches"] == sum(bucket["batch_sizes"].values())
        assert len(results) == total

    def test_errors_counted_in_reconciliation(self):
        srv = _server(autostart=False)
        bad = srv.submit(request("cg", n=64, iters=2,
                                 feeds={"b": np.ones(3)}))
        srv.start()
        with pytest.raises(ValueError):
            bad.result(timeout=120)
        srv.close()
        st = srv.stats()
        assert st["requests"] == 1 and st["errors"] == 1
        ok, served = _reconciles(st)
        assert ok and served == 0

    def test_latency_quantiles_match_streaming_histogram(self):
        from repro_torch.obs import HIST_REL_ERROR
        srv = _server(max_batch_size=4)
        lat = [srv.solve(request("cg", n=64, iters=2, seed=s)).latency_s
               for s in range(12)]
        srv.close()
        (bucket,) = srv.stats()["buckets"].values()
        summ = bucket["latency"]
        assert summ["count"] == 12
        assert summ["sum"] == pytest.approx(sum(lat))
        for q, p in (("p50", 50), ("p99", 99)):
            exact = float(np.percentile(lat, p, method="inverted_cdf"))
            assert abs(summ[q] - exact) / exact <= HIST_REL_ERROR + 1e-9
        assert bucket["queue_wait"]["count"] == 12


class TestShutdownRaces:
    @pytest.fixture(autouse=True)
    def _clean_rules(self):
        faults.clear()
        yield
        faults.clear()

    def test_close_flush_waits_for_in_flight_batch(self):
        srv = _server(max_batch_size=2, max_wait_us=200)
        srv.solve(request("cg", n=32, iters=2))
        with faults.inject("serve.dispatch", kind="slow", delay_s=0.3,
                           times=1):
            fut = srv.submit(request("cg", n=32, iters=2, seed=1))
            time.sleep(0.05)
            srv.close(flush=True)
        assert fut.result(timeout=1).batch_size == 1
        with pytest.raises(ServerClosed):
            srv.submit(request("cg", n=32, iters=2, seed=2))

    def test_close_noflush_fails_queued_futures_typed(self):
        srv = _server(max_batch_size=4, max_wait_us=200, autostart=False)
        futs = [srv.submit(request("cg", n=32, iters=2, seed=s))
                for s in range(3)]
        srv.close(flush=False)
        for f in futs:
            with pytest.raises(ServerClosed, match="closed"):
                f.result(timeout=1)
        st = srv.stats()
        assert st["errors"] == 3 and st["queue_depth"] == 0

    def test_poisoned_batch_does_not_poison_the_bucket(self):
        srv = _server(max_batch_size=2, max_wait_us=200, autostart=False)
        futs = [srv.submit(request("cg", n=32, iters=2, seed=s))
                for s in range(4)]                # two batches of 2
        with faults.inject("serve.dispatch", kind="fail", times=1):
            srv.start()
            for f in futs[:2]:
                with pytest.raises(faults.InjectedFault):
                    f.result(timeout=60)
            for f in futs[2:]:
                assert f.result(timeout=60).batch_size == 2
        st = srv.stats()
        assert st["errors"] == 2 and st["requests"] == 4
        srv.close()


class TestClientCancelRaces:
    def test_cancelled_future_does_not_crash_the_batch(self):
        srv = _server(max_batch_size=4, max_wait_us=200, autostart=False)
        futs = [srv.submit(request("cg", n=32, iters=2, seed=s))
                for s in range(3)]
        assert futs[1].cancel()
        srv.start()
        assert futs[0].result(timeout=60).batch_size == 2
        assert futs[2].result(timeout=60).batch_size == 2
        assert futs[1].cancelled()
        h = srv.health()
        assert h["status"] == "ok" and h["worker_restarts"] == 0
        st = srv.stats()
        assert st["requests"] == 3 and st["errors"] == 1
        srv.close()

    def test_cancel_racing_shed_does_not_raise_in_submitter(self):
        srv = _server(max_batch_size=8, max_wait_us=50_000,
                      autostart=False, max_queue=1, overload="shed_oldest")
        f1 = srv.submit(request("cg", n=32, iters=2, seed=1))
        assert f1.cancel()
        f2 = srv.submit(request("cg", n=32, iters=2, seed=2))
        assert f1.cancelled()
        srv.start()
        assert f2.result(timeout=60).batch_size == 1
        srv.close()

    def test_shed_head_does_not_restart_the_wait_window(self):
        srv = _server(max_batch_size=8, max_wait_us=500_000, max_queue=1,
                      overload="shed_oldest")
        srv.solve(request("cg", n=32, iters=2))
        t0 = time.monotonic()
        f1 = srv.submit(request("cg", n=32, iters=2, seed=1))
        time.sleep(0.25)
        f2 = srv.submit(request("cg", n=32, iters=2, seed=2))
        with pytest.raises(Overloaded):
            f1.result(timeout=1)
        assert f2.result(timeout=60).batch_size == 1
        assert time.monotonic() - t0 < 0.68
        srv.close()


class TestTypedRequestsAndConfig:
    def test_request_bucket_method_is_the_canonicalization(self):
        req = request("cg_sparse", n=64, iters=2, density=0.0011)
        router = PlanRouter(session=_session())
        assert req.bucket() == router.bucket(req)
        assert req.bucket().density == "d0.001"
        assert isinstance(req, SolveRequest)

    def test_deadline_rides_on_the_request(self):
        srv = Server(None, ServeConfig(max_batch_size=4, autostart=False),
                     session=_session())
        with pytest.raises(ValueError, match="deadline_s"):
            srv.submit(request("cg", n=32, iters=2, deadline_s=-1.0))
        fut = srv.submit(request("cg", n=32, iters=2, deadline_s=60.0))
        srv.start()
        assert fut.result(timeout=120).batch_size == 1
        srv.close()

    def test_positional_config_and_session(self):
        srv = Server(ServeConfig(max_batch_size=4, autostart=False),
                     session=_session())
        assert srv.max_batch_size == 4
        assert srv.router.session.device == "cpu"
        srv.close()

    def test_mixed_fp32_fp64_buckets_one_server(self):
        srv = _server(max_batch_size=8)
        try:
            r32 = srv.submit(request("cg", n=64, iters=3, seed=1,
                                     backend="cuda")).result(timeout=120)
            r64 = srv.submit(request("cg", n=64, iters=3, seed=1,
                                     dtype="float64", backend="cuda")
                             ).result(timeout=120)
            assert r32.outputs["x3"].dtype == torch.float32
            assert r64.outputs["x3"].dtype == torch.float64
            np.testing.assert_allclose(_np(r32.outputs["x3"]),
                                       _np(r64.outputs["x3"]).astype(
                                           np.float32),
                                       rtol=1e-3, atol=1e-5)
            labels = set(srv.stats()["buckets"])
            assert any("float64" in lb for lb in labels)
            assert any("float32" in lb for lb in labels)
        finally:
            srv.close()


def test_router_default_session_is_on_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="CUDA"):
        PlanRouter()


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
                         ids=DT_IDS)
def test_b2_b4_lanes_are_b2_b4_per_lane_on_the_card(cuda_device, dtype):
    from repro_torch.kernels.spmv import spmv
    from repro_torch.kernels.stencil import stencil2d
    p = jx_fe.Program("spmv")
    A = p.sparse_operator("A", (4096, 4096), pattern="laplacian5")
    p.output(p.spmv(A, p.input("x", (4096,)), name="y"))
    f = feeds_from_numpy(jx_fe.make_feeds(p, seed=6), cuda_device)
    csr = [f["A.indptr"], f["A.indices"], f["A.data"].to(dtype)]
    X = torch.randn(19, 4096, device=cuda_device, dtype=dtype)
    Y = spmv_lanes(*csr, X, 4096)
    for i in range(19):
        assert torch.equal(Y[i], spmv(*csr, X[i], 4096))
    U = torch.randn(5, 64, 68, device=cuda_device, dtype=dtype)
    F = torch.randn(5, 64, 68, device=cuda_device, dtype=dtype)
    out = stencil2d_lanes(U, F, 1.0, lanes=5)
    for i in range(5):
        assert torch.equal(out[i], stencil2d(U[i], F[i], 1.0))


@pytest.mark.gpu
def test_served_batch_is_one_graph_replay_on_the_card(cuda_device):
    srv = Server(PlanRouter(Session(device="cuda")),
                 ServeConfig(max_batch_size=4, autostart=False))
    futs = [srv.submit(request("cg_sparse", n=4096, iters=8, seed=s,
                               backend="cuda")) for s in range(4)]
    srv.start()
    res = [f.result(timeout=300) for f in futs]
    srv.close()
    (b,) = srv.stats()["buckets"].values()
    assert b["dispatches"] == b["batches"] == 1 and b["traces"] == 1
    assert all(r.outputs["x8"].device.type == "cuda" for r in res)
