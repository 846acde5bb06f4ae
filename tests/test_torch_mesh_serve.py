"""Serving over the LLM mesh on the CPU: the per-slot prefill
(``models.sharded.forward``) and the mesh decode step (``jit_decode_step(
cfg, plan, mesh, batch, seq_len)``) of every family against the port's
unsharded model and the JAX package's, and the decode step's signature.

Reduced configs of one arch a family (granite-3-8b, granite-moe-1b-a400m,
recurrentgemma-2b, rwkv6-7b, hubert-xlarge, llama-3.2-vision-11b), weights
from JAX ``init_params`` through ``params_from_numpy``, on meshes of 4
slots: (2, 2) (data and model) and (1, 4) (TP 4: the reduced configs' 2 kv
heads do not split 4 ways, so attention is query-split, one query head a
slot, and the cache is sequence-sharded).  Logits and caches are held to
``ULPS`` bf16 ulps at the tensor's largest magnitude, the standard of
``tests/test_torch_models.py``: the sharded model sums its row-parallel
partials in another order and rounds each partial to bf16.  Against the
port, the plans' kernel flags are on (the kernels' plain versions on the
CPU); against JAX, off on both sides (the JAX package's CPU paths).  An
MoE model runs on the routes of the port's unsharded run, replayed
(``models.moe.route`` swapped for the test), so the runs differ by
rounding alone; its meshes keep one data slot, where its grouping is the
unsharded one; data slots route a group each, which
``test_moe_data_slots_route_a_group_each`` holds against the JAX
package's ``apply_moe(groups=)``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jx_get
from repro.core.policy import default_plan as jx_default_plan
from repro.models import decode_step as jx_decode
from repro.models import forward as jx_forward
from repro.models import init_cache as jx_init_cache
from repro.models import init_params as jx_init_params
import repro.models.moe as jx_moe
import repro_torch.models.moe as pt_moe
from repro_torch.api import Session
from repro_torch.configs import get_config as pt_get
from repro_torch.core.policy import default_plan as pt_default_plan
from repro_torch.launch import shardings as shd
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.serve import (DecodeStep, MeshDecodeStep,
                                      jit_decode_step)
from repro_torch.models import (decode_step, forward, init_cache,
                                params_from_numpy, sharded)

ARCHS = ["granite-3-8b", "granite-moe-1b-a400m", "recurrentgemma-2b",
         "rwkv6-7b", "hubert-xlarge", "llama-3.2-vision-11b"]
ULPS = 8
B, S, Z, STEPS = 4, 12, 16, 6


def _bf16_ulps(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(got - want).max() / ulp)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    torch.set_num_threads(1)
    jcfg = jx_get(request.param).reduced()
    pcfg = pt_get(request.param).reduced()
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(lambda a: np.array(a), jparams)
    rng = np.random.default_rng(7)
    stub = {}
    if pcfg.family == "audio":
        stub["frames"] = rng.standard_normal((B, S, pcfg.d_model))
    if pcfg.family == "vlm":
        stub["img"] = rng.standard_normal((B, pcfg.vision_seq, pcfg.d_model))
    return dict(name=request.param, jcfg=jcfg, pcfg=pcfg, jparams=jparams,
                pparams=params_from_numpy(tree, pcfg, device="cpu"),
                tokens=rng.integers(0, pcfg.vocab, (B, S)), stub=stub)


def _meshes(a):
    # an MoE model keeps one data slot (module docstring)
    return [(1, 2), (1, 4)] if a["pcfg"].is_moe else [(2, 2), (1, 4)]


def _plans(a, flags: bool):
    kw = dict(use_flash_attention=flags, use_fused_mlp=flags)
    jplan = dataclasses.replace(jx_default_plan(a["jcfg"], seq=64), **kw)
    pplan = dataclasses.replace(pt_default_plan(a["pcfg"], seq=64), **kw,
                                use_fused_rmsnorm=flags)
    return jplan, pplan


def _stubs(a, jax_side=False):
    conv = ((lambda v: jnp.asarray(v, jnp.bfloat16)) if jax_side else
            (lambda v: torch.from_numpy(v).to(torch.bfloat16)))
    return {k: conv(v) for k, v in a["stub"].items()}


class _Routes:
    """``models.moe.route`` recorded (``record``) or replayed in call
    order (``replay``), for the test only."""

    def __init__(self, monkeypatch):
        self.mp, self.orig, self.routes = monkeypatch, pt_moe.route, []

    def record(self):
        def route(*args, **kw):
            r = self.orig(*args, **kw)
            self.routes.append(r)
            return r
        self.mp.setattr(pt_moe, "route", route)

    def replay(self):
        queue = iter(list(self.routes))

        def route(w_router, x, *, top_k, capacity_factor):
            rec = next(queue)
            probs = torch.softmax(x.float() @ w_router.float(), dim=-1)
            gates = probs.gather(-1, rec.idx)
            gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True),
                                            1e-9)
            return pt_moe.Routing(gates, rec.idx, rec.slot, rec.keep,
                                  rec.capacity)
        self.mp.setattr(pt_moe, "route", route)


def _shard(a, mesh):
    _, sh = shd.params_for(a["pcfg"], mesh)
    return shd.shard_tree(a["pparams"], sh)


def _entries(cache_entries):
    """Every tensor of a prefill's per-layer cache entries."""
    for e in cache_entries:
        yield from (e if isinstance(e, tuple) else (e,))


@pytest.mark.parametrize("flags", [True, False], ids=["kernels", "plain"])
def test_sharded_prefill_matches_the_port_and_jax(arch, flags, monkeypatch):
    a, cfg = arch, arch["pcfg"]
    jplan, pplan = _plans(a, flags)
    tok = torch.from_numpy(a["tokens"])
    routes = _Routes(monkeypatch)
    if cfg.is_moe:
        routes.record()
    want, want_c = forward(a["pparams"], cfg, pplan, tok, **_stubs(a))
    if not flags:
        jlogits, _ = jx_forward(a["jparams"], a["jcfg"], jplan,
                                jnp.asarray(a["tokens"], jnp.int32),
                                mode="prefill", unroll=True,
                                **_stubs(a, jax_side=True))
        assert _bf16_ulps(_np(want), _np(jlogits)) <= ULPS
    for mesh_shape in _meshes(a):
        mesh = make_local_mesh(*mesh_shape, device="cpu")
        if cfg.is_moe:
            routes.replay()
        got, got_c = sharded.forward(_shard(a, mesh), cfg, pplan, tok,
                                     **_stubs(a))
        assert got.shape == want.shape and got.dtype == torch.float32
        assert _bf16_ulps(_np(got), _np(want)) <= ULPS, mesh_shape
        for g, w in zip(_entries(got_c), _entries(want_c)):
            assert g.shape == w.shape and g.dtype == w.dtype
            assert _bf16_ulps(_np(g), _np(w)) <= ULPS, mesh_shape
        if not flags:
            assert _bf16_ulps(_np(got), _np(jlogits)) <= ULPS, mesh_shape
        # a shifted position is not within the limit
        assert _bf16_ulps(_np(got[:, 1:]), _np(want[:, :-1])) > ULPS


@pytest.mark.parametrize("flags", [True, False], ids=["kernels", "plain"])
def test_mesh_decode_step_matches_the_port_and_jax(arch, flags,
                                                   monkeypatch):
    a, cfg = arch, arch["pcfg"]
    jplan, pplan = _plans(a, flags)
    routes = _Routes(monkeypatch)
    if cfg.is_moe:
        routes.record()
    cache = init_cache(cfg, B, Z, device="cpu")
    want = []
    for t in range(STEPS):
        lg, cache = decode_step(a["pparams"], cache, cfg, pplan,
                                torch.from_numpy(a["tokens"][:, t:t + 1]), t)
        want.append(lg)
    if not flags:
        jc = jx_init_cache(a["jcfg"], B, Z)
        jwant = []
        for t in range(STEPS):
            lg, jc = jx_decode(a["jparams"], jc, a["jcfg"], jplan,
                               jnp.asarray(a["tokens"][:, t:t + 1],
                                           jnp.int32), jnp.int32(t),
                               unroll=True)
            jwant.append(lg)
    for mesh_shape in _meshes(a):
        mesh = make_local_mesh(*mesh_shape, device="cpu")
        if cfg.is_moe:
            routes.replay()
        step = jit_decode_step(cfg, pplan, mesh, B, Z)
        assert isinstance(step, MeshDecodeStep)
        sparams = _shard(a, mesh)
        scache = shd.shard_tree(init_cache(cfg, B, Z, device="cpu"),
                                step.c_shardings)
        for t in range(STEPS):
            lg, out = step(sparams, scache,
                           torch.from_numpy(a["tokens"][:, t:t + 1]), t)
            assert out is scache                     # donated, in place
            assert _bf16_ulps(_np(lg), _np(want[t])) <= ULPS, (mesh_shape, t)
            if not flags:
                assert _bf16_ulps(_np(lg), _np(jwant[t])) <= ULPS
        assert step.stats == {"traces": 1, "dispatches": STEPS}
        for e_got, e_want in zip(shd.gather_tree(scache)["layers"],
                                 cache["layers"]):
            for k in e_want:
                if k == "pos_idx":
                    assert torch.equal(e_got[k], e_want[k])
                else:
                    assert _bf16_ulps(_np(e_got[k]), _np(e_want[k])) <= ULPS


def test_moe_data_slots_route_a_group_each():
    """granite-moe's reduced MoE FFN on (2, 2): each data slot's tokens
    are one group, as the JAX package's ``apply_moe(groups=2)``; the
    experts' products of the two model slots summed in fp32, bitwise the
    reference on identical bf16 inputs."""
    cfg = pt_get("granite-moe-1b-a400m").reduced()
    plan = pt_default_plan(cfg, seq=64)
    D, T = cfg.d_model, 40
    jp = jx_moe.init_moe_params(jax.random.PRNGKey(2), D, cfg.d_ff,
                                cfg.n_experts, cfg.activation, jnp.float32)
    pp = {n: torch.from_numpy(np.array(v)) for n, v in jp.items()}
    x = np.random.default_rng(1).standard_normal((T, D)).astype(np.float32)
    yj = np.asarray(jx_moe.apply_moe(
        jp, jnp.asarray(x, jnp.bfloat16), top_k=cfg.top_k,
        activation=cfg.activation, capacity_factor=plan.moe_capacity_factor,
        groups=2).astype(jnp.float32))
    mesh = make_local_mesh(2, 2, device="cpu")
    specs = shd.resolve_tree(mesh, pt_moe.moe_pspecs(cfg.activation), pp)
    sp = shd.shard_tree(pp, specs)
    xt = torch.from_numpy(x).to(torch.bfloat16).reshape(2, T // 2, D)
    hs = [xt[mesh.index(k, "data")][None] for k in range(mesh.size)]
    out = sharded.apply_moe(sp, hs, cfg, plan)
    for k in range(mesh.size):
        g = mesh.index(k, "data")
        np.testing.assert_array_equal(
            out[k][0].float().numpy(), yj[g * (T // 2):(g + 1) * (T // 2)])


def test_mesh_of_one_slot_is_the_unsharded_step_bitwise():
    cfg = pt_get("granite-3-8b").reduced()
    plan = pt_default_plan(cfg, seq=64)
    from repro_torch.models import init_params
    params = init_params(cfg, seed=1, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, S)))
    mesh = make_local_mesh(1, 1, device="cpu")
    step = jit_decode_step(cfg, plan, mesh, B, Z)
    c1 = init_cache(cfg, B, Z, device="cpu")
    c2 = init_cache(cfg, B, Z, device="cpu")       # global: sharded, returned
    with pytest.raises(TypeError, match="per-slot params"):
        step(params, c2, tok[:, :1], 0)
    sp = shd.shard_tree(params, step.p_shardings)
    for t in range(4):
        want, c1 = decode_step(params, c1, cfg, plan, tok[:, t:t + 1], t)
        got, c2 = step(sp, c2, tok[:, t:t + 1], t)
        assert torch.equal(got, want)
    assert step.exchanged == dict.fromkeys(
        ("psum", "pmax", "all_gather", "ppermute", "gather", "n_psum",
         "n_pmax", "n_all_gather", "n_ppermute", "n_gather"), 0)
    # the returned cache is the per-slot one, so the step traced once
    assert step.stats == {"traces": 1, "dispatches": 4}
    for a, b in zip(shd.tree_leaves(shd.gather_tree(c2)),
                    shd.tree_leaves(c1)):
        assert torch.equal(a, b)
    sp = shd.shard_tree(params, shd.params_for(cfg, mesh)[1])
    lg, _ = sharded.forward(sp, cfg, plan, tok)
    assert torch.equal(lg, forward(params, cfg, plan, tok)[0])


def test_decode_step_takes_the_reference_signature():
    """``jit_decode_step(cfg, plan, mesh, batch, seq_len)``: a call in the
    reference's positional form builds a step for that batch and cache
    length; an int where the mesh goes raises (the old form would have
    taken the batch for the mesh); the bundle keys its steps by (mesh,
    batch, seq_len) and ``generate`` decodes through the mesh-less one."""
    cfg = pt_get("granite-3-8b").reduced()
    plan = pt_default_plan(cfg, seq=64)
    step = jit_decode_step(cfg, plan, None, 3, 20)
    assert type(step) is DecodeStep and (step.batch, step.seq_len) == (3, 20)
    mesh = make_local_mesh(2, 2, device="cpu")
    mstep = jit_decode_step(cfg, plan, mesh, 4, 24)
    assert isinstance(mstep, MeshDecodeStep)
    assert (mstep.batch, mstep.seq_len, mstep.mesh) == (4, 24, mesh)
    with pytest.raises(TypeError, match="DeviceMesh or None"):
        jit_decode_step(cfg, plan, 4, 48, 16)
    with pytest.raises(TypeError, match="seq_len must be an int"):
        jit_decode_step(cfg, plan, None, 4, mesh)
    with pytest.raises(TypeError):
        jit_decode_step(cfg, plan, 4, 48)          # the pre-mesh form
    bundle = Session(cfg, device="cpu").default_plan(seq=64).serve()
    assert bundle.jit_decode(mesh, 4, 24) is bundle.jit_decode(mesh, 4, 24)
    assert bundle.jit_decode(None, 4, 24) is not bundle.jit_decode(
        mesh, 4, 24)
    with pytest.raises(TypeError, match="DeviceMesh or None"):
        bundle.jit_decode(4, 48, 16)
    from repro_torch.models import init_params
    params = init_params(cfg, seed=0, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 4)))
    toks = bundle.generate(params, prompt, 3)
    assert toks.shape == (2, 7)
    assert bundle.jit_decode(None, 2, 7).stats == {"traces": 1,
                                                   "dispatches": 6}
    # a cache that is not cache_for's for the step raises, and so do
    # global params (a copy of them would miss in-place updates)
    sp = shd.shard_tree(params, mstep.p_shardings)
    with pytest.raises(ValueError, match="cache_for"):
        mstep(sp, shd.shard_tree(
            init_cache(cfg, 4, 16, device="cpu"),
            shd.cache_for(cfg, mesh, 4, 16)[1]),
            torch.zeros((4, 1), dtype=torch.long), 0)
    with pytest.raises(TypeError, match="per-slot params"):
        mstep(params, init_cache(cfg, 4, 24, device="cpu"),
              torch.zeros((4, 1), dtype=torch.long), 0)


_JAX_MESH_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import sys; sys.path.insert(0, "src")
import dataclasses, json
import numpy as np
import jax, jax.numpy as jnp
import torch
from jax.sharding import Mesh
from repro.configs import get_config as jx_get
from repro.core.policy import default_plan as jx_default_plan
from repro.launch.serve import jit_decode_step as jx_jit_decode_step
from repro.launch import shardings as jx_shd
from repro.models import init_cache as jx_init_cache
from repro.models import init_params as jx_init_params
from repro.models import set_mesh_context
from repro_torch.configs import get_config as pt_get
from repro_torch.core.policy import default_plan as pt_default_plan
from repro_torch.launch import shardings as shd
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.serve import jit_decode_step
from repro_torch.models import init_cache, params_from_numpy

B, Z, STEPS = 4, 16, 5
jcfg = jx_get("granite-3-8b").reduced()
pcfg = pt_get("granite-3-8b").reduced()
off = dict(use_flash_attention=False, use_fused_mlp=False)
jplan = dataclasses.replace(jx_default_plan(jcfg, seq=64), **off)
pplan = dataclasses.replace(pt_default_plan(pcfg, seq=64), **off,
                            use_fused_rmsnorm=False)
jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
pparams = params_from_numpy(jax.tree.map(np.array, jparams), pcfg,
                            device="cpu")
tokens = np.random.default_rng(5).integers(0, pcfg.vocab, (B, STEPS))

jmesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
jstep = jx_jit_decode_step(jcfg, jplan, jmesh, B, Z)
_, p_sh = jx_shd.params_for(jcfg, jmesh)
_, c_sh = jx_shd.cache_for(jcfg, jmesh, B, Z)
jp = jax.device_put(jparams, p_sh)
jc = jax.device_put(jx_init_cache(jcfg, B, Z), c_sh)
set_mesh_context(None)

pmesh = make_local_mesh(2, 4, device="cpu")
pstep = jit_decode_step(pcfg, pplan, pmesh, B, Z)
sp = shd.shard_tree(pparams, pstep.p_shardings)
sc = shd.shard_tree(init_cache(pcfg, B, Z, device="cpu"), pstep.c_shardings)
worst = 0.0
for t in range(STEPS):
    set_mesh_context(jmesh)
    jl, jc = jstep(jp, jc, jnp.asarray(tokens[:, t:t + 1], jnp.int32),
                   jnp.int32(t))
    set_mesh_context(None)
    pl, sc = pstep(sp, sc, torch.from_numpy(tokens[:, t:t + 1]), t)
    want = np.asarray(jl, np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    worst = max(worst, float(np.abs(pl.double().numpy() - want).max() / ulp))
jk = np.asarray(jc["periods"]["slot0"]["k"].astype(jnp.float32))
pk = shd.gather_tree(sc)["layers"]
kv = max(float(np.abs(pk[i]["k"].float().numpy() - jk[i]).max())
         for i in range(pcfg.n_layers))
print(json.dumps({"worst_ulps": worst, "k_max_abs": kv,
                  "jax_k_spec": list(jc["periods"]["slot0"]["k"]
                                     .sharding.spec),
                  "port_k_spec": list(sc["layers"][0]["k"].sharding.spec),
                  "devices": len(jax.devices())}))
"""


def test_mesh_decode_step_matches_jax_on_a_forced_host_mesh():
    """The port's (2, 4) decode step against the JAX package's own
    ``jit_decode_step`` on an 8-device forced host mesh (a subprocess, as
    ``tests/test_integration.py`` runs its mesh), reduced granite-3-8b,
    the plans' kernel flags off: logits within ``ULPS`` bf16 ulps at
    every step, the caches' shardings the same."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _JAX_MESH_SCRIPT], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["devices"] == 8
    assert out["worst_ulps"] <= ULPS, out
    assert out["k_max_abs"] < 0.1, out
    # 2 kv heads at TP 4: the cache is sequence-sharded on both sides (the
    # JAX one's leading entry is its stacked period axis)
    assert out["port_k_spec"] == ["data", "model", None, None]
    assert out["jax_k_spec"][1:] == out["port_k_spec"], out
