"""Training over the LLM mesh on the CPU: ``jit_train_step(cfg, plan,
opt_cfg, mesh, train_cfg, batch_specs=...)`` against the unsharded step and
the JAX package's own mesh step, ZeRO-1's moments, and the elastic
checkpoint restore.

The sharded loss and every gathered gradient leaf are held to
``max(MIN_TOL, 2 x spread)`` of the unsharded step's (2-norm relative
error a leaf), where the spread is the unsharded kernel-flags step's
against the flags-off step's, the same function summed in other orders:
the mesh sums its row-parallel partials in fp32 after rounding each to
bf16, which in the bf16 backward moves a reduced model's gradients by
about the spread (~1.5e-2 on granite-3-8b reduced).  A mesh of one slot
is the unsharded step bitwise.

After AdamW steps the same rule holds each quantity of the state: the
loss and ``grad_norm`` of every step, and leaf by leaf the update
(params less the initial ones), ``m`` and ``v``, each against the spread
of that quantity between the port's unsharded flags-on and flags-off
steps.  AdamW's first steps move a weight by about ``lr`` times the sign
of its gradient, so the update's spread is large (~0.2 on granite-3-8b
reduced: the signs of near-zero gradients flip); the moments' spread is
~1.5e-2 and ``grad_norm``'s ~2e-4, so a moment applied to the wrong
sub-block, a wrong global norm or clip scale, or a data slot's slice
left unupdated moves them far past their limits.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import checkpoint
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.policy import default_plan
from repro_torch.launch import shardings as shd
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.train import (MeshTrainStep, TrainConfig,
                                      init_opt_state, jit_train_step,
                                      make_loss_fn, make_mesh_loss_fn,
                                      make_train_step, optimizer_shardings,
                                      stub_inputs, value_and_grad)
from repro_torch.models import init_params, sharded
from repro_torch.optim import AdamWConfig, adamw_init

MIN_TOL = 1e-3
B, S = 4, 16
OPT = AdamWConfig(warmup_steps=1, total_steps=10)
IS_SHARDED = lambda x: isinstance(x, shd.Sharded)  # noqa: E731


def _setup(arch, seed=0):
    torch.set_num_threads(1)
    cfg = get_config(arch).reduced()
    plan = dataclasses.replace(default_plan(cfg, seq=S),
                               use_flash_attention=True, use_fused_mlp=True,
                               use_fused_rmsnorm=True)
    params = init_params(cfg, seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))),
             **stub_inputs(cfg, B, S, 0, "cpu")}
    return cfg, plan, params, batch


def _specs(cfg, mesh):
    return shd.input_specs(cfg, ShapeSpec("cell", S, B, "train"), mesh)


def _rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a.float() - b.float())
                 / torch.linalg.vector_norm(b.float()))


def _steps(cfg, plan, params, batch, n=2):
    """``n`` unsharded AdamW steps: (params, state, [metrics])."""
    step = make_train_step(cfg, plan, OPT, TrainConfig(donate=False))
    p, st, ms = params, adamw_init(params), []
    for _ in range(n):
        p, st, m = step(p, st, batch)
        ms.append(m)
    return p, st, ms


def _state_errs(got, want, p0):
    """Relative errors of (params, state, [metrics]) ``got`` against
    ``want``: the worst step's loss and grad_norm, the worst leaf's update
    (params less ``p0``), ``m`` and ``v``."""
    p, st, ms = got
    p_w, st_w, ms_w = want
    out = {k: max(abs(float(a[k]) - float(b[k])) / abs(float(b[k]))
                  for a, b in zip(ms, ms_w)) for k in ("loss", "grad_norm")}
    out["update"] = max(_rel(a - z, b - z) for a, b, z in zip(
        shd.tree_leaves(p), shd.tree_leaves(p_w), shd.tree_leaves(p0)))
    for k in ("m", "v"):
        out[k] = max(_rel(a, b) for a, b in zip(shd.tree_leaves(st[k]),
                                                shd.tree_leaves(st_w[k])))
    return out


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("arch", ["granite-3-8b", "recurrentgemma-2b",
                                  "rwkv6-7b"])
def test_sharded_gradients_match_the_unsharded_step(arch, mesh_shape):
    cfg, plan, params, batch = _setup(arch)
    tc = TrainConfig()
    loss_u, g_u = value_and_grad(make_loss_fn(cfg, plan, tc))(params, batch)
    off = dataclasses.replace(plan, use_flash_attention=False,
                              use_fused_mlp=False, use_fused_rmsnorm=False)
    loss_o, g_o = value_and_grad(make_loss_fn(cfg, off, tc))(params, batch)
    leaves_u = shd.tree_leaves(g_u)
    spread = max(_rel(a, b) for a, b in zip(shd.tree_leaves(g_o), leaves_u))
    tol = max(MIN_TOL, 2 * spread)
    loss_tol = max(MIN_TOL, 2 * abs(float(loss_o - loss_u)) / float(loss_u))
    mesh = make_local_mesh(*mesh_shape, device="cpu")
    sp = shd.shard_tree(params, shd.params_for(cfg, mesh)[1])
    loss_s, g_s = sharded.value_and_grad(
        make_mesh_loss_fn(cfg, plan, tc))(sp, batch)
    assert abs(float(loss_s - loss_u)) / float(loss_u) <= loss_tol
    for s in shd.tree_leaves(g_s, IS_SHARDED):   # replicas hold one value
        for grp in mesh.groups(tuple(a for a in mesh.axis_names
                                     if a not in s.sharding.axes())):
            for k in grp[1:]:
                assert torch.equal(s.parts[k], s.parts[grp[0]])
    gathered = shd.tree_leaves(shd.gather_tree(g_s))
    err = max(_rel(a, b) for a, b in zip(gathered, leaves_u))
    assert err <= tol, (err, tol, spread)
    assert all(bool(torch.isfinite(a).all()) for a in gathered)


def test_mesh_of_one_slot_is_the_unsharded_step_bitwise():
    cfg, plan, params, batch = _setup("granite-3-8b", seed=2)
    mesh = make_local_mesh(1, 1, device="cpu")
    step = jit_train_step(cfg, plan, OPT, mesh, TrainConfig(donate=False),
                          batch_specs=_specs(cfg, mesh))
    sp, so = step.shard(params)
    ref = make_train_step(cfg, plan, OPT, TrainConfig(donate=False))
    p_u, s_u = params, adamw_init(params)
    for _ in range(2):
        sp, so, m = step(sp, so, batch)
        p_u, s_u, m_u = ref(p_u, s_u, batch)
        assert float(m["loss"]) == float(m_u["loss"])
        assert float(m["grad_norm"]) == float(m_u["grad_norm"])
    for a, b in zip(shd.tree_leaves(shd.gather_tree(sp)),
                    shd.tree_leaves(p_u)):
        assert torch.equal(a, b)
    for a, b in zip(shd.tree_leaves(shd.gather_tree(so["m"])),
                    shd.tree_leaves(s_u["m"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("zero1", [True, False], ids=["zero1", "replicated"])
def test_zero1_moments_and_replicas_after_steps(zero1):
    """Each moment block has its ZeRO-1 spec's shape (a data slot's slice
    of the param block) or, without ZeRO-1, the param block's; after two
    donated steps the data replicas of every param block are bitwise
    equal, params and moments are written in place, and the losses, the
    grad norms and the gathered update and moments agree with the
    unsharded steps' within the limits of the module docstring."""
    cfg, plan, params, batch = _setup("granite-3-8b", seed=1)
    mesh = make_local_mesh(2, 2, device="cpu")
    tc = TrainConfig(zero1=zero1, donate=True)
    step = jit_train_step(cfg, plan, OPT, mesh, tc,
                          batch_specs=_specs(cfg, mesh))
    assert isinstance(step, MeshTrainStep)
    o_sh = optimizer_shardings(cfg, mesh, zero1)
    sp, so = step.shard(params)
    for m, sh, p in zip(shd.tree_leaves(so["m"], IS_SHARDED),
                        shd.tree_leaves(o_sh["m"]),
                        shd.tree_leaves(sp, IS_SHARDED)):
        assert m.sharding == sh
        for k in range(mesh.size):
            assert tuple(m.parts[k].shape) == sh.shard_shape(m.shape)
        if zero1 and "data" in sh.axes():
            assert m.parts[0].numel() * 2 == p.parts[0].numel()
    held = [t.data_ptr() for s in shd.tree_leaves(sp, IS_SHARDED)
            for t in s.parts]
    moments = [t.data_ptr() for s in shd.tree_leaves(so["v"], IS_SHARDED)
               for t in s.parts]
    out_p, out_o, metric_log = sp, so, []
    for _ in range(2):
        out_p, out_o, metrics = step(out_p, out_o, batch)
        metric_log.append(metrics)
    assert out_p is sp and out_o is so                       # donated
    assert [t.data_ptr() for s in shd.tree_leaves(sp, IS_SHARDED)
            for t in s.parts] == held
    assert [t.data_ptr() for s in shd.tree_leaves(so["v"], IS_SHARDED)
            for t in s.parts] == moments
    assert all(int(c) == 2 for c in so["count"].parts)
    for s in shd.tree_leaves(sp, IS_SHARDED):
        for grp in mesh.groups(("data",)):
            assert torch.equal(s.parts[grp[0]], s.parts[grp[1]])
    if zero1:
        assert step.exchanged["all_gather"] > 0
    # the gathered state against the unsharded steps' (module docstring)
    ref = _steps(cfg, plan, params, batch)
    off = dataclasses.replace(plan, use_flash_attention=False,
                              use_fused_mlp=False, use_fused_rmsnorm=False)
    spread = _state_errs(_steps(cfg, off, params, batch), ref, params)
    errs = _state_errs((shd.gather_tree(sp), shd.gather_tree(so),
                        metric_log), ref, params)
    for k, err in errs.items():
        assert err <= max(MIN_TOL, 2 * spread[k]), (k, err, spread)


def test_accum_and_remat_act_per_slot():
    cfg, plan, params, batch = _setup("granite-3-8b", seed=4)
    mesh = make_local_mesh(2, 2, device="cpu")
    specs = _specs(cfg, mesh)
    losses = {}
    for name, tc in (("base", TrainConfig(donate=False)),
                     ("no_remat", TrainConfig(donate=False, remat=False)),
                     ("accum", TrainConfig(donate=False, accum_steps=2))):
        step = jit_train_step(cfg, plan, OPT, mesh, tc, batch_specs=specs)
        sp, so = step.shard(params)
        p2, _, m = step(sp, so, batch)
        losses[name] = (float(m["loss"]), shd.gather_tree(p2))
    # remat recomputes the same ops: bitwise
    assert losses["base"][0] == losses["no_remat"][0]
    for a, b in zip(shd.tree_leaves(losses["base"][1]),
                    shd.tree_leaves(losses["no_remat"][1])):
        assert torch.equal(a, b)
    # two micro-batches of 2: the mean of their losses
    loss_fn = make_mesh_loss_fn(cfg, plan, TrainConfig())
    sp = shd.shard_tree(params, shd.params_for(cfg, mesh)[1])
    halves = [float(loss_fn(sp, {k: v[i * 2:(i + 1) * 2]
                                 for k, v in batch.items()}))
              for i in range(2)]
    assert abs(losses["accum"][0] - sum(halves) / 2) < 1e-5


def test_train_step_needs_batch_specs():
    cfg, plan, _, _ = _setup("granite-3-8b")
    mesh = make_local_mesh(2, 2, device="cpu")
    with pytest.raises(ValueError, match="batch_specs required"):
        jit_train_step(cfg, plan, OPT, mesh, TrainConfig())
    step = jit_train_step(cfg, plan, OPT, mesh, TrainConfig(),
                          batch_specs=_specs(cfg, mesh))
    with pytest.raises(ValueError, match="batch keys"):
        step(init_params(cfg, seed=0, device="cpu"), None,
             {"tokens": torch.zeros((B, S), dtype=torch.long)})


def test_checkpoint_restores_onto_another_mesh(tmp_path):
    """A training state saved from a (2, 2) mesh is the reference's
    layout on disk (global leaves, the specs recorded) and restores into
    a (1, 4) mesh's per-slot form, bitwise once gathered."""
    cfg, plan, params, batch = _setup("granite-3-8b", seed=5)
    m22 = make_local_mesh(2, 2, device="cpu")
    step = jit_train_step(cfg, plan, OPT, m22, TrainConfig(),
                          batch_specs=_specs(cfg, m22))
    sp, so = step.shard(params)
    sp, so, _ = step(sp, so, batch)
    d = str(tmp_path / "ck")
    ck = checkpoint.AsyncCheckpointer(d)
    ck.save(1, {"params": sp, "opt": so}, extra={"step": 1})
    ck.wait()
    import json
    import os
    with open(os.path.join(d, "step_00000001", "meta.json")) as f:
        meta = json.load(f)
    key = "__params__--__layers__--_0_--__attn__--__wq__"
    assert meta["arrays"][key]["shape"] == [cfg.d_model, cfg.n_heads
                                            * cfg.resolved_head_dim]
    assert meta["arrays"][key]["pspec"] == [None, "model"]
    m14 = make_local_mesh(1, 4, device="cpu")
    target = {"params": init_params(cfg, device="meta"),
              "opt": adamw_init(init_params(cfg, seed=0, device="cpu"))}
    o14 = optimizer_shardings(cfg, m14)
    shardings = {"params": shd.params_for(cfg, m14)[1], "opt": o14}
    loaded, extra = checkpoint.load_checkpoint(d, 1, target,
                                               shardings=shardings)
    assert extra == {"step": 1}
    assert loaded["params"]["embed"].sharding.mesh is m14
    for a, b in zip(shd.tree_leaves(shd.gather_tree(loaded)),
                    shd.tree_leaves(shd.gather_tree({"params": sp,
                                                     "opt": so}))):
        assert torch.equal(a, b)
    # the restored state trains on the new mesh
    step14 = jit_train_step(cfg, plan, OPT, m14, TrainConfig(),
                            batch_specs=_specs(cfg, m14))
    _, _, m = step14(loaded["params"], loaded["opt"], batch)
    assert np.isfinite(float(m["loss"]))
    # and into a global tree, without shardings
    flat, _ = checkpoint.load_checkpoint(
        d, 1, {"params": init_params(cfg, seed=9, device="cpu"),
               "opt": target["opt"]})
    assert torch.equal(flat["params"]["embed"], sp["embed"].gather())


def test_init_opt_state_is_zero_on_every_slot():
    cfg, _, params, _ = _setup("rwkv6-7b")
    mesh = make_local_mesh(2, 2, device="cpu")
    sp = shd.shard_tree(params, shd.params_for(cfg, mesh)[1])
    st = init_opt_state(sp, optimizer_shardings(cfg, mesh))
    for s in shd.tree_leaves(st, IS_SHARDED):
        assert all(not bool(p.any()) for p in s.parts)
    assert st["count"].parts[0].dtype == torch.int32


_JAX_MESH_TRAIN_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import sys; sys.path.insert(0, "src"); sys.path.insert(0, "tests")
import dataclasses, json
import numpy as np
import jax, jax.numpy as jnp
import torch
from jax.sharding import Mesh
from repro.configs import get_config as jx_get
from repro.configs.base import ShapeSpec as JxShapeSpec
from repro.core.policy import default_plan as jx_default_plan
from repro.launch import shardings as jx_shd
from repro.launch.train import TrainConfig as JxTrainConfig
from repro.launch.train import jit_train_step as jx_jit_train_step
from repro.launch.train import optimizer_shardings as jx_opt_shardings
from repro.models import init_params as jx_init_params
from repro.models import set_mesh_context
from repro.optim import AdamWConfig as JxAdamWConfig
from repro.optim import adamw_init as jx_adamw_init
from repro_torch.configs import get_config as pt_get
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.policy import default_plan as pt_default_plan
from repro_torch.launch import shardings as shd
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.train import TrainConfig, jit_train_step
from repro_torch.models import params_from_numpy
from test_torch_mesh_train import OPT, _state_errs, _steps

torch.set_num_threads(1)
B, S, STEPS = 4, 16, 2
jcfg = jx_get("granite-3-8b").reduced()
pcfg = pt_get("granite-3-8b").reduced()
jplan = dataclasses.replace(jx_default_plan(jcfg, seq=S),
                            use_flash_attention=False, use_fused_mlp=False)
on = dataclasses.replace(pt_default_plan(pcfg, seq=S),
                         use_flash_attention=True, use_fused_mlp=True,
                         use_fused_rmsnorm=True)
off = dataclasses.replace(on, use_flash_attention=False,
                          use_fused_mlp=False, use_fused_rmsnorm=False)
jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
rng = np.random.default_rng(7)
tokens = rng.integers(0, pcfg.vocab, (B, S))
labels = rng.integers(0, pcfg.vocab, (B, S))
jopt = JxAdamWConfig(**dataclasses.asdict(OPT))

jmesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
specs = jx_shd.input_specs(jcfg, JxShapeSpec("cell", S, B, "train"), jmesh)
jstep = jx_jit_train_step(jcfg, jplan, jopt, jmesh,
                          JxTrainConfig(donate=False), batch_specs=specs)
_, p_sh = jx_shd.params_for(jcfg, jmesh)
o_sh = jx_opt_shardings(jcfg, jmesh, True)
jp = jax.device_put(jparams, p_sh)
jo = jax.device_put(jx_adamw_init(jparams), o_sh)
jb = {"tokens": tokens, "labels": labels}
jb = {k: jax.device_put(jnp.asarray(v, jnp.int32), specs[k].sharding)
      for k, v in jb.items()}
jm = []
for _ in range(STEPS):
    jp, jo, m = jstep(jp, jo, jb)
    jm.append({k: float(v) for k, v in m.items()})
set_mesh_context(None)

def port(tree):
    return params_from_numpy(jax.tree.map(np.array, tree), pcfg,
                             device="cpu")

p0 = port(jparams)
batch = {"tokens": torch.from_numpy(tokens),
         "labels": torch.from_numpy(labels)}
pmesh = make_local_mesh(2, 4, device="cpu")
pstep = jit_train_step(
    pcfg, off, OPT, pmesh, TrainConfig(donate=False),
    batch_specs=shd.input_specs(pcfg, ShapeSpec("cell", S, B, "train"),
                                pmesh))
sp, so = pstep.shard(p0)
pm = []
for _ in range(STEPS):
    sp, so, m = pstep(sp, so, batch)
    pm.append(m)
mine = (shd.gather_tree(sp), shd.gather_tree(so), pm)
jax_state = (port(jp), {"m": port(jo["m"]), "v": port(jo["v"])}, jm)
spread = _state_errs(_steps(pcfg, off, p0, batch, STEPS),
                     _steps(pcfg, on, p0, batch, STEPS), p0)
spec = lambda s: [a[0] if isinstance(a, tuple) and len(a) == 1 else a
                  for a in s]
print(json.dumps({
    "devices": len(jax.devices()), "errs": _state_errs(mine, jax_state, p0),
    "spread": spread,
    "jax_m_spec": spec(jo["m"]["periods"]["slot0"]["attn"]["wq"]
                       .sharding.spec)[1:],
    "port_m_spec": spec(so["m"]["layers"][0]["attn"]["wq"].sharding.spec)}))
"""


def test_mesh_train_step_matches_jax_on_a_forced_host_mesh():
    """The port's (2, 4) ZeRO-1 train step against the JAX package's own
    ``jit_train_step`` on an 8-device forced host mesh (a subprocess, as
    ``tests/test_integration.py`` runs its mesh), reduced granite-3-8b,
    the same weights, batch and AdamW, the plans' kernel flags off on
    both sides, two steps: the loss and ``grad_norm`` of each, and leaf by
    leaf the gathered update, ``m`` and ``v``, within ``max(MIN_TOL, 2 x
    spread)`` of the JAX state's, the spread the port's own unsharded
    flags-on step against its flags-off step (module docstring); and the
    moments' ZeRO-1 specs the same."""
    import json
    import os
    import subprocess
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    res = subprocess.run([sys.executable, "-c", _JAX_MESH_TRAIN_SCRIPT],
                         cwd=os.path.dirname(here), capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["devices"] == 8
    for k, err in out["errs"].items():
        assert err <= max(MIN_TOL, 2 * out["spread"][k]), (k, out)
    assert out["port_m_spec"] == out["jax_m_spec"], out
    assert out["port_m_spec"] == ["data", "model"]
