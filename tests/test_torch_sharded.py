"""The solver mesh on the CPU: ``Session(device="cpu").lower(mesh=K)``.

Held against the JAX package's mesh path (``repro.core.lowering.
partition_plan``, ``repro.exec.sharded.ShardedReference``) on the same
numpy feeds, and against the port's own unsharded plans:

* ``partition_plan`` equals the JAX package's field for field (it is the
  same pure Python), its rejections included;
* the port's ``ShardedReference`` equals the port's unsharded reference
  **bitwise** at K = 4 and 8 (reductions run on gathered-whole operands;
  a row block's product ``A_k @ p`` equals those rows of ``A @ p`` on the
  CPU at these sizes, n = 256);
* the port's ``ShardedReference`` and ``ShardedProgram`` (the ``cuda``
  backend; on CPU tensors every kernel runs its plain version) agree with
  the JAX package's ``ShardedReference`` within the cross-package table of
  ``tests/test_torch_exec.py``: fp32 rtol 2e-4 / atol 1e-5, fp64 rtol
  1e-9 / atol 1e-12 (the program's reductions sum row blocks, then
  shards; JAX's oracle sums whole vectors);
* K = 1 is the unsharded plan, bitwise, on both backends;
* B1's deferred-finalize mode: its plain version's raw sums, after the
  psum and the square root, are the ordinary pass's (bitwise on one
  shard, within 1e-6 of the norm at K = 4);
* ``stats`` of the CPU walk and the ``ExecConfig`` surface.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.api as jx_api
import repro.frontends as jx_fe
from repro.core.lowering import partition_plan as jx_partition_plan
import repro_torch.api as pt_api
import repro_torch.frontends as pt_fe
from repro_torch import kernels
from repro_torch.core.lowering import PlanPartitionError, partition_plan
from repro_torch.exec import get_backend
from repro_torch.kernels.stream import StreamKernel
from repro_torch.launch.mesh import make_solver_mesh

TOL = {np.float32: dict(rtol=2e-4, atol=1e-5),
       np.float64: dict(rtol=1e-9, atol=1e-12)}

MESH_SET = [
    ("cg", dict(n=256, iters=4)),
    ("cg_sparse", dict(n=256, iters=4)),
    ("jacobi2d", dict(n=64, sweeps=3)),
    ("power_iteration", dict(n=256, iters=3)),
]
IDS = [w for w, _ in MESH_SET]
MiB = 1024 * 1024


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _bitwise(got, want, what=""):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), (what, k)


def _close(got, want, dtype, what=""):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), **TOL[dtype],
                                   err_msg=f"{what} {k}")


def _pt(workload, params, config=None):
    traced = pt_api.Session(device="cpu").trace(workload=workload, **params)
    return traced, traced.analyze().codesign(config)


def _jx(workload, params, config=None):
    traced = jx_api.Session(use_cache=False).trace(workload=workload,
                                                   **params)
    return traced, traced.analyze().codesign(config)


def _feeds(program, seed=0, dtype=np.float32):
    return pt_fe.feeds_from_numpy(pt_fe.make_feeds(program, seed=seed,
                                                   dtype=dtype))


# --------------------------------------------------------------------------
# partition_plan against the JAX package's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("workload,params", MESH_SET, ids=IDS)
def test_partition_plan_equals_jax(workload, params, k):
    _, jx_cd = _jx(workload, params)
    _, pt_cd = _pt(workload, params)
    jx_sp = jx_cd.lower(mesh=k).sharded
    pt_sp = pt_cd.lower(mesh=k).sharded
    assert dataclasses.asdict(pt_sp) == dataclasses.asdict(jx_sp)
    assert pt_sp.describe() == jx_sp.describe()


def test_csr_entry_windows_at_k8():
    """cg_sparse's CSR triple splits on indptr-aligned entry windows: the
    cumulative row counts of the pattern meta at every shard boundary, a
    padded window that holds the widest shard, equal to the JAX
    package's."""
    from repro_torch.frontends.sparse import row_counts
    traced, cd = _pt("cg_sparse", dict(n=256, iters=2))
    sp = cd.lower(mesh=8).sharded
    assert sp.n_shards == 8 and sp.rows == 256
    (lay,) = sp.csr
    leaf = traced.program.nodes[lay.indptr]
    counts = row_counts(leaf.param("pattern"), 256,
                        density=leaf.param("density"),
                        bandwidth=leaf.param("bandwidth"))
    cum = np.concatenate([[0], np.cumsum(counts)])
    assert list(lay.entry_starts) == [int(cum[k * 32]) for k in range(9)]
    assert lay.entry_starts[-1] == lay.nnz
    widest = max(b - a for a, b in zip(lay.entry_starts,
                                       lay.entry_starts[1:]))
    assert lay.pad_entries >= widest and lay.pad_entries % 8 == 0
    for k, sl in enumerate(lay.slices):
        assert sl.rows == 32 and sl.row0 == k * 32
        assert sl.entries == lay.entry_starts[k + 1] - lay.entry_starts[k]
    _, jx_cd = _jx("cg_sparse", dict(n=256, iters=2))
    (jlay,) = jx_cd.lower(mesh=8).sharded.csr
    assert dataclasses.asdict(lay) == dataclasses.asdict(jlay)


def test_exchange_sets():
    _, cd = _pt("cg", dict(n=256, iters=4))
    sp = cd.lower(mesh=8).sharded
    assert set(sp.gathered) == {"x0", "r0", "p1", "p2", "p3"}
    assert "rs0" in sp.reduced and "pAp0" in sp.reduced
    assert not sp.halo
    _, cdj = _pt("jacobi2d", dict(n=64, sweeps=3))
    spj = cdj.lower(mesh=4).sharded
    assert set(spj.halo) == {"u1", "u2", "u3"}
    assert not spj.gathered


@pytest.mark.parametrize("workload,params,k", [
    ("cg", dict(n=256, iters=2), 3),                  # ragged rows
    ("mttkrp", dict(i=8, j=8, k=8, rank=4), 4),       # no row-block split
], ids=["ragged", "mttkrp"])
def test_partition_rejections_match_jax(workload, params, k):
    """What the row-block split cannot express fails at lower time, with
    the JAX package's message."""
    msgs = []
    for mk, part in ((_pt, partition_plan), (_jx, jx_partition_plan)):
        traced, cd = mk(workload, params)
        with pytest.raises(ValueError) as exc:
            part(cd.lower().exec_plan, k, program=traced.program)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(PlanPartitionError):
        _pt(workload, params)[1].lower(mesh=k)


def test_overbooked_pins_are_rejected():
    params = dict(n=64, iters=3, pattern="banded", bandwidth=2)
    cfg = dict(overbook=0.25, capacity_bytes=4500)
    traced, cd = _pt("cg_sparse", params, pt_api.CodesignConfig(**cfg))
    _, jcd = _jx("cg_sparse", params, jx_api.CodesignConfig(**cfg))
    partial = dict(cd.best.schedule.pins.partial)
    assert partial.keys() == dict(jcd.best.schedule.pins.partial).keys()
    assert partial, "the search no longer takes a prefix pin here"
    with pytest.raises(PlanPartitionError, match="overbook"):
        partition_plan(cd.lower().exec_plan, 4, program=traced.program)
    with pytest.raises(PlanPartitionError, match="overbook"):
        cd.lower(mesh=1)


def test_per_shard_pins_at_aggregate_capacity():
    """TABLE 11's crossover: ``A`` does not fit one slot's explicit region
    and pins once the mesh is wide enough, as in the JAX package."""
    cap = int(0.4 * MiB)
    params = dict(n=512, iters=4)                    # A = 1 MiB fp32
    traced, cd = _pt("cg", params, pt_api.CodesignConfig(capacity_bytes=cap))
    _, jcd = _jx("cg", params, jx_api.CodesignConfig(capacity_bytes=cap))
    assert "A" not in cd.best.schedule.pins
    p8 = cd.lower(mesh=8)
    assert p8.codesigned.capacity_bytes == 8 * cap
    assert "A" in p8.codesigned.best.schedule.pins
    j8 = jcd.lower(mesh=8)
    assert dict(p8.codesigned.best.schedule.pins) == \
        dict(j8.codesigned.best.schedule.pins)
    assert p8.codesigned.speedup() == j8.codesigned.speedup()
    feeds = _feeds(traced.program)
    _bitwise(p8.run(feeds, backend="reference"),
             cd.lower(backend="reference").run(feeds), "K=8 vs unsharded")


# --------------------------------------------------------------------------
# execution
# --------------------------------------------------------------------------

@pytest.mark.parametrize("workload,params", MESH_SET, ids=IDS)
def test_sharded_reference_is_bitwise_the_unsharded(workload, params):
    traced, cd = _pt(workload, params)
    feeds = _feeds(traced.program)
    ref = cd.lower(backend="reference").run(feeds)
    for k in (4, 8):
        plan = cd.lower(mesh=k, backend="reference")
        assert type(plan.compiled()).__name__ == "ShardedReference"
        _bitwise(plan.run(feeds), ref, f"{workload} K={k}")


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["fp32", "fp64"])
@pytest.mark.parametrize("workload,params", MESH_SET, ids=IDS)
def test_sharded_paths_match_jax_sharded_reference(workload, params, dtype):
    jtraced, jcd = _jx(workload, params)
    traced, cd = _pt(workload, params)
    feeds = jx_fe.make_feeds(jtraced.program, seed=5, dtype=dtype)
    with jax.enable_x64(dtype == np.float64):
        want = jcd.lower(mesh=4, backend="reference").run(feeds)
        want = {k: np.asarray(v) for k, v in want.items()}
    for k in want:
        assert want[k].dtype == dtype, k
    pt_feeds = pt_fe.feeds_from_numpy(feeds)
    for backend in ("reference", "cuda"):
        got = cd.lower(mesh=4, backend=backend).run(pt_feeds)
        _close(got, want, dtype, f"{workload} {backend} vs JAX sharded")


@pytest.mark.parametrize("workload,params", MESH_SET, ids=IDS)
def test_sharded_program_within_tolerance_of_the_oracle(workload, params):
    traced, cd = _pt(workload, params)
    plan = cd.lower(mesh=8)
    prog = plan.compiled()
    assert type(prog).__name__ == "ShardedProgram"
    for dtype in (np.float32, np.float64):
        feeds = _feeds(traced.program, seed=2, dtype=dtype)
        _close(plan.run(feeds), plan.run(feeds, backend="reference"), dtype,
               f"{workload} program vs oracle")


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("workload,params", MESH_SET, ids=IDS)
def test_mesh_of_one_is_the_unsharded_plan(workload, params, backend):
    traced, cd = _pt(workload, params)
    feeds = _feeds(traced.program)
    k1 = cd.lower(mesh=1, backend=backend)
    assert k1.sharded is not None and k1.sharded.n_shards == 1
    assert type(k1.compiled()).__name__ != "ShardedProgram"
    _bitwise(k1.run(feeds), cd.lower(backend=backend).run(feeds))


def test_sharded_program_stats_on_the_cpu_walk():
    traced, cd = _pt("cg_sparse", dict(n=256, iters=3))
    prog = get_backend("cuda").compile(cd.lower(mesh=4))
    assert prog.stats == {"runs": 0, "traces": 0, "dispatches": 0,
                          "launches": dict.fromkeys(kernels.LAUNCHES, 0)}
    for runs in (1, 2, 3):
        out = prog(_feeds(traced.program, seed=runs))
        assert prog.stats["dispatches"] == prog.stats["runs"] == runs
        assert prog.stats["traces"] == 1
        _bitwise(out, prog.walk(_feeds(traced.program, seed=runs)))
    prog(_feeds(traced.program, dtype=np.float64))
    assert prog.stats["traces"] == 2 and prog.stats["runs"] == 4
    # on CPU tensors every wrapper runs its plain version: no launches
    assert not any(prog.stats["launches"].values())


def test_cuda_perunit_runs_the_unsharded_walk():
    traced, cd = _pt("cg", dict(n=256, iters=3))
    feeds = _feeds(traced.program)
    _bitwise(cd.lower(mesh=4).run(feeds, backend="cuda-perunit"),
             cd.lower().run(feeds, backend="cuda-perunit"))


# --------------------------------------------------------------------------
# B1's deferred-finalize mode
# --------------------------------------------------------------------------

def _norm_pass(workload, params):
    """The first B1 pass of the unsharded cuda program that holds a
    norm, and its inputs (seeded)."""
    traced, cd = _pt(workload, params)
    prog = get_backend("cuda").compile(cd.lower())
    for call in (*prog._pro, *prog._tmpl, *prog._epi):
        k = getattr(call, "pass_", None)
        if k is not None and k.norm_reductions:
            break
    rng = np.random.default_rng(3)
    env = {n: torch.from_numpy(np.asarray(rng.standard_normal(k.shapes[n])))
           .float() for n in k.in_names}
    return cd, k, env


@pytest.mark.parametrize("workload,params", [
    ("power_iteration", dict(n=256, iters=3)),
    ("gmres", dict(n=256, restart=3)),
], ids=["power_iteration", "gmres"])
def test_deferred_plain_on_one_shard_is_the_pass(workload, params):
    _, k, env = _norm_pass(workload, params)
    needed = set(k.stream_out) | set(k.scalar_out)
    d = StreamKernel(k.nodes, k.shapes, needed, k.rows, defer_finalize=True)
    assert d.names == ("stream_deferred", "stream_deferred_finalize")
    assert d.scalar_out == [] and d.norm_reductions == k.norm_reductions
    whole, raw = k.plain(env), d.plain(env)
    assert sorted(raw) == sorted(d.stream_out + d.red_out)
    for n in d.stream_out:
        assert torch.equal(raw[n], whole[n]), n
    vals = dict(env, **raw)
    for n in d.red_out:
        # the psum over one shard is the shard's raw sum itself
        vals[n] = torch.sqrt(raw[n]) if n in d.norm_reductions else raw[n]
    for nd in d.finalize_nodes:
        from repro_torch.exec.reference import eval_node
        vals[nd.name] = eval_node(nd, [vals[t] for t in nd.inputs])
    for n in k.scalar_out:
        assert torch.equal(vals[n], whole[n]), n


@pytest.mark.parametrize("workload,params", [
    ("power_iteration", dict(n=256, iters=3)),
    ("gmres", dict(n=256, restart=3)),
], ids=["power_iteration", "gmres"])
def test_deferred_norms_psum_then_sqrt_at_k4(workload, params):
    """Four shards' raw sums of squares, folded in shard order and then
    square-rooted, give the ordinary pass's norm within 1e-6 of it (fp32:
    the row blocks' sums reassociate)."""
    cd, k, env = _norm_pass(workload, params)
    shards = 4
    sprog = get_backend("cuda").compile(cd.lower(mesh=shards))
    names = [nd.name for nd in k.nodes]
    local = next(c.unit.pass_ for c in (*sprog._pro, *sprog._tmpl)
                 if hasattr(c, "unit") and c.unit.pass_ is not None
                 and [nd.name for nd in c.unit.pass_.nodes] == names)
    assert local.defer and local.rows == k.rows // shards
    rl = local.rows
    mesh = make_solver_mesh(shards, device="cpu")
    parts = []
    for j in range(shards):
        env_j = {}
        for n in local.in_names:
            v = env[n[:-2] if n.endswith("@g") else n]
            env_j[n] = (v if tuple(v.shape) == local.shapes[n]
                        else v[j * rl:(j + 1) * rl])
        parts.append(local.plain(env_j))
    for n in local.norm_reductions:
        total = mesh.psum([p[n] for p in parts])
        assert all(torch.equal(t, total[0]) for t in total)
        got = float(torch.sqrt(total[0]))
        nd = next(nd for nd in k.nodes if nd.name == n)
        want = float(k._plain_node(nd, [
            k.plain(env)[t] if t in names else env[t] for t in nd.inputs]))
        assert abs(got - want) <= 1e-6 * abs(want), (n, got, want)


def test_deferred_finalize_source_folds_only():
    """The deferred pass's generated finalize kernel stores one raw sum
    per reduction: no square root, no scalar chain."""
    _, k, _ = _norm_pass("power_iteration", dict(n=256, iters=3))
    d = StreamKernel(k.nodes, k.shapes, set(k.stream_out) | set(k.scalar_out),
                     k.rows, defer_finalize=True)
    for dtype in (torch.float32, torch.float64):
        main_src, fin_src = d.source(dtype).split("def finalize_kernel")
        assert main_src == k.source(dtype).split("def finalize_kernel")[0]
        assert "sqrt" not in fin_src and "sqrt" in \
            k.source(dtype).split("def finalize_kernel")[1]
        assert fin_src.count("tl.store(") == len(d.red_out)


# --------------------------------------------------------------------------
# the mesh and the ExecConfig surface
# --------------------------------------------------------------------------

def test_solver_mesh_exchanges_in_shard_order():
    mesh = make_solver_mesh(4, axis="blocks", device="cpu")
    assert mesh.n_shards == 4 and mesh.axis == "blocks"
    assert mesh.describe() == "4 shards over 1 device (cpu)"
    t = torch.arange(8.0).reshape(8, 1)
    blocks = mesh.split(t)
    assert [b[:, 0].tolist() for b in blocks] == [[0, 1], [2, 3], [4, 5],
                                                  [6, 7]]
    whole = mesh.all_gather(blocks)
    assert len({w.data_ptr() for w in whole}) == 4
    assert all(torch.equal(w, t) for w in whole)
    assert torch.equal(mesh.concat(blocks), t)
    # a left fold: ((1e8 + 1) - 1e8) + 1 in fp32
    parts = [torch.tensor(v, dtype=torch.float32)
             for v in (1e8, 1.0, -1e8, 1.0)]
    total = mesh.psum(parts)
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert all(torch.equal(s, want) for s in total)
    assert len({s.data_ptr() for s in total}) == 4
    nxt = mesh.ppermute([b[-1:] for b in blocks], 1)
    assert [float(r) for r in nxt] == [7, 1, 3, 5]
    prv = mesh.ppermute([b[:1] for b in blocks], -1)
    assert [float(r) for r in prv] == [2, 4, 6, 0]
    with pytest.raises(ValueError, match="split evenly"):
        make_solver_mesh(3, device="cpu").split(t)


def test_exec_config_mesh_surface():
    traced, cd = _pt("cg", dict(n=128, iters=2))
    plan = cd.lower(pt_api.ExecConfig(mesh=("blocks", 4)))
    assert plan.sharded.axis == "blocks" and plan.backend == "cuda"
    assert "mesh=blocks:4" in plan.plan.notes
    assert plan.report()["mesh"] == {
        "axis": "blocks", "n_shards": 4, "rows_per_shard": 32,
        "plan": plan.sharded.describe()}
    line = [ln for ln in plan.explain().splitlines()
            if ln.startswith("  device mesh")]
    assert line and line[0].endswith("4 shards over 1 device (cpu)")
    feeds = _feeds(traced.program)
    _bitwise(plan.run(feeds, config=pt_api.ExecConfig(backend="reference")),
             cd.lower(backend="reference").run(feeds))
    with pytest.raises(ValueError, match="re-lower"):
        plan.run(feeds, config=pt_api.ExecConfig(mesh=2))
    with pytest.raises(ValueError, match="re-lower"):
        plan.batched(config=pt_api.ExecConfig(mesh=2))
    with pytest.raises(TypeError, match="not both"):
        cd.lower(pt_api.ExecConfig(), mesh=4)
    # a sharded plan has no lane-batched program
    with pytest.raises(ValueError, match="mesh-sharded"):
        plan.batched()
    from repro_torch.serve import BatchedPlan
    with pytest.raises(ValueError, match="mesh-sharded"):
        BatchedPlan(cd.lower(mesh=4))


def test_llm_plans_take_no_mesh():
    sess = pt_api.Session("granite-3-8b", device="cpu")
    cd = sess.trace("decode", batch=1, kv_len=128).codesign()
    with pytest.raises(ValueError, match="mesh"):
        cd.lower(mesh=2)


@pytest.mark.gpu
def test_sharded_program_on_the_card():
    """On a card: one graph replay a run over four slots, B2 and deferred
    B1 launched, within the table of the ``ShardedReference`` run on the
    card, and the deferred passes bitwise against the ordinary ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    traced = pt_api.Session(device="cuda").trace(workload="cg_sparse",
                                                 n=4096, iters=8)
    plan = traced.analyze().codesign().lower(mesh=4)
    feeds = pt_fe.feeds_from_numpy(pt_fe.make_feeds(traced.program, seed=0),
                                   "cuda")
    out = plan.run(feeds)
    again = plan.run(feeds)
    _close(out, plan.run(feeds, backend="reference"), np.float32,
           "program vs oracle on the card")
    _bitwise(again, out)
    stats = plan.compiled().stats
    assert stats["traces"] == 1 and stats["dispatches"] == stats["runs"] == 2
    for k in ("spmv", "stream_deferred", "stream_deferred_finalize"):
        assert stats["launches"][k] > 0, k
    for call in plan.compiled()._tmpl:
        k = call.unit.pass_
        if k is None:
            continue
        env = {n: torch.randn(k.shapes[n], device="cuda")
               for n in k.in_names}
        ordinary = StreamKernel(k.nodes, k.shapes, set(k.out_names), k.rows)
        got, whole = k(env), ordinary(env)
        for n in got:
            want = whole[n]
            assert torch.equal(torch.sqrt(got[n]) if n in k.norm_reductions
                               else got[n], want), n
