"""The checks that ``chip_smoke.py`` holds phase 4's Krylov paths, mttkrp
and phase 5's serving paths to, run here at small sizes.

* Each witness (``chip_smoke.Witness``): bicgstab's and bicgstab_sparse's
  relative residual, gmres's ‖v_m‖ = 1, power iteration's Rayleigh gap
  and mttkrp against ``numpy.einsum`` in fp64.
  The port's ``cuda`` backend (each kernel's plain version on CPU tensors)
  and the JAX package's ``pallas`` backend (interpret mode; fp64 under
  ``jax.enable_x64(True)``) get the same numpy feeds from
  ``make_feeds(seed=0)``; the witness must accept both runs, the port's run
  must hold ``PATH_TOL`` against its ``reference`` backend, and the control
  (``lowered_reference``: the products' operands cut to TF32 in fp32, to
  fp32 in fp64) must fail ``PATH_TOL`` through the smoke's own
  ``hold_witness``.
* Phase 4's path table names every workload, and phases 5, 6 and 9 every
  registered arch, each dense arch with B5, B6, B7 launched (L, L, 2L + 1)
  times a prefill.
* Why gmres and the Laplacian's bicgstab_sparse run short on the card:
  deeper, two summation orders part by more than ``PATH_TOL``.
"""
import importlib.util
import pathlib

import jax
import numpy as np
import pytest

import repro.api as jx_api
from repro_torch.api import Session
from repro_torch.configs import get_config, list_archs
from repro_torch.frontends import feeds_from_numpy, make_feeds
from repro_torch.frontends.hpc import WORKLOADS

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load_smoke()

#: the new phase-4 paths at small sizes (n <= 256), with their witnesses
SMALL = [
    ("bicgstab", dict(n=256, iters=8), "DENSE_RESIDUAL"),
    ("gmres", dict(n=256, restart=6), "UNIT_NORM"),
    ("power_iteration", dict(n=256, iters=32), "RAYLEIGH"),
    ("mttkrp", dict(i=16, j=12, k=10, rank=8), "NUMPY_EINSUM"),
    ("bicgstab_sparse", dict(n=256, iters=8, pattern="laplacian5"),
     "SPARSE_RESIDUAL"),
    ("bicgstab_sparse", dict(n=256, iters=8, pattern="random",
                             density=0.05), "SPARSE_RESIDUAL"),
]
IDS = [f"{w}-{p.get('pattern', 'dense')}" for w, p, _ in SMALL]
DTYPES = {"float32": np.float32, "float64": np.float64}


def _runs(workload, params, dt):
    """(port plan, numpy feeds, port cuda run, port reference run, JAX
    pallas run), all on the CPU."""
    traced = Session(device="cpu").trace(workload=workload, **params)
    plan = traced.analyze().codesign().lower(backend="cuda")
    feeds_np = make_feeds(traced.program, seed=0, dtype=DTYPES[dt])
    feeds = feeds_from_numpy(feeds_np)
    out = plan.run(feeds)
    ref = plan.run(feeds, backend="reference")
    jx_plan = (jx_api.Session(use_cache=False)
               .trace(workload=workload, **params).analyze().codesign()
               .lower())
    with jax.enable_x64(dt == "float64"):
        pal = {k: np.asarray(v) for k, v in
               jx_plan.run(feeds_np, backend="pallas").items()}
    assert all(v.dtype == DTYPES[dt] for v in pal.values())
    return plan, feeds_np, feeds, out, ref, pal


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("workload, params, witness", SMALL, ids=IDS)
def test_witness_accepts_the_port_and_pallas_and_rejects_the_control(
        workload, params, witness, dt):
    w = getattr(cs, witness)
    plan, feeds_np, feeds, out, ref, pal = _runs(workload, params, dt)
    # the witness reads the port's run and the JAX package's alike
    rec = w.check({"cuda": w.value(out, feeds_np),
                   "reference": w.value(pal, feeds_np)}, dt)
    assert np.isfinite(rec[w.name]) and np.isfinite(
        rec[f"{w.name}_reference"])
    # the port's run against its reference, as phase 4 holds it
    b = feeds_np.get("b")
    scale_b = float(np.abs(b).max()) if b is not None else 0.0
    assert cs._compare(out, ref, scale_b, dt, workload) <= cs.PATH_TOL[dt]
    # the smoke's own witness and control: PATH_TOL rejects the cut run
    held = cs.hold_witness(plan, feeds, feeds_np, out, ref, scale_b, dt, w)
    assert held["control_rel_err"] > cs.PATH_TOL[dt]
    assert f"control_{w.name}" in held
    assert isinstance(held["control_rejected_by_witness"], bool)


@pytest.mark.parametrize("witness", ["DENSE_RESIDUAL", "RAYLEIGH",
                                     "UNIT_NORM", "NUMPY_EINSUM"])
def test_a_witness_rejects_a_reading_past_its_limit(witness):
    w = getattr(cs, witness)
    if w.name in ("rel_residual", "rayleigh_gap"):
        bad = {"cuda": 1e-3, "reference": 1e-3 + 2 * cs.RESIDUAL_GAP}
    else:
        bad = {"cuda": 2 * cs.PATH_TOL["float32"], "reference": 0.0}
    with pytest.raises(AssertionError):
        w.check(bad, "float32")
    with pytest.raises(AssertionError):
        w.check({"cuda": float("nan"), "reference": 0.0}, "float32")


def test_rayleigh_gap_is_zero_at_an_eigenvector():
    rng = np.random.default_rng(3)
    m = rng.standard_normal((32, 32))
    A = m @ m.T / 32 + np.eye(32)
    vals, vecs = np.linalg.eigh(A)
    x = vecs[:, -1]
    lam = np.linalg.norm(A @ x)
    gap = cs.rayleigh_gap({"x8": x, "lam7": np.float64(lam)}, {"A": A})
    assert abs(gap) < 1e-12 and abs(lam - vals[-1]) < 1e-12


def test_phase4_names_every_workload():
    named = {wl for wl, _params, _dts, _w in cs.HPC_PATHS}
    assert named | set(cs.OB_WORKLOADS) == set(WORKLOADS)
    # the Krylov paths and mttkrp run in fp32 and fp64, a witness each
    for wl, params, dts, witness in cs.HPC_PATHS:
        if wl in ("bicgstab", "gmres", "power_iteration", "mttkrp",
                  "bicgstab_sparse"):
            assert dts == ("float32", "float64") and witness is not None
    names = [cs.path_name(wl, p) for wl, p, _d, _w in cs.HPC_PATHS]
    assert len(set(names)) == len(names)
    assert names[:3] == ["cg(n=4096, iters=64)",
                         "cg_sparse(n=1048576, iters=64, laplacian5)",
                         "jacobi2d(n=4096, sweeps=8)"]


def test_serving_phases_name_every_arch_with_dense_launches():
    served = [p[0] for p in cs.SERVE_PATHS] + [p[0] for p in
                                               cs.FAMILY_PATHS]
    assert sorted(served) == sorted(list_archs())
    for arch, seq, _kind, want, tols, layers in cs.SERVE_PATHS:
        cfg = get_config(arch)
        if cfg.family != "dense":
            continue
        L = layers or cfg.n_layers
        assert layers is None                   # every layer
        assert (want["flash_attention"], want["fused_mlp"],
                want["rmsnorm"]) == (L, L, 2 * L + 1)
        assert tols == (cs.LLM_TOL, cs.DECODE_TOL)
        if cfg.window:                          # the window bites
            assert seq > cfg.window


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("workload, long, short", [
    ("gmres", dict(n=256, restart=32), dict(n=256, restart=cs.GMRES_RESTART)),
    ("bicgstab_sparse", dict(n=4096, iters=32, pattern="laplacian5"),
     dict(n=4096, iters=cs.BICGSTAB_LAPLACIAN_ITERS, pattern="laplacian5")),
], ids=["gmres", "bicgstab_sparse-laplacian5"])
def test_long_krylov_depths_part_any_two_summation_orders(workload, long,
                                                          short, dt):
    """Why phase 4 runs gmres at ``GMRES_RESTART`` and bicgstab_sparse on
    the Laplacian at ``BICGSTAB_LAPLACIAN_ITERS``: at the longer depth the
    JAX package's own reference and the port's (two libraries, two
    summation orders, the same arithmetic) part by far more than
    ``PATH_TOL``, so no implementation could be held to it there; at the
    depth kept they agree within a tenth of it."""
    import torch
    import repro.frontends as jx_fe
    import repro_torch.frontends as pt_fe

    def spread(params):
        feeds = jx_fe.make_feeds(jx_fe.build_workload(workload, **params),
                                 seed=0, dtype=DTYPES[dt])
        with jax.enable_x64(dt == "float64"):
            want = jx_fe.evaluate(jx_fe.build_workload(workload, **params),
                                  feeds)
            want = {k: torch.from_numpy(np.array(v)) for k, v in
                    want.items()}
        got = pt_fe.evaluate(pt_fe.build_workload(workload, **params),
                             pt_fe.feeds_from_numpy(feeds))
        return cs._rel_err(got, want, float(np.abs(feeds["b"]).max()))
    assert spread(long) > 10 * cs.PATH_TOL[dt]
    assert spread(short) <= cs.PATH_TOL[dt] / 2
