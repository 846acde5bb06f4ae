"""The training stack's parts against the JAX package's: the synthetic data
pipeline, the fault-tolerance policies, AdamW and the int8 compression on
identical numpy inputs, and the checkpoint store's layout and commit
protocol."""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro import checkpoint as jx_ckpt
from repro import data as jx_data
from repro import optim as jx_optim
from repro import runtime as jx_runtime
from repro_torch import checkpoint, data, optim, runtime

#: AdamW and the schedule, port against JAX on identical fp32 inputs:
#: max |Δ| <= REL x max |JAX| per leaf (the same expressions in fp32; the
#: global norm sums its leaves in another order)
OPT_REL = 1e-6


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["markov", "uniform"])
@pytest.mark.parametrize("shards", [1, 2])
def test_synthetic_batches_are_bitwise_the_jax_packages(kind, shards):
    kw = dict(vocab=97, seq_len=24, global_batch=4, seed=5, kind=kind,
              branching=3)
    for shard in range(shards):
        mine = data.SyntheticLMData(data.DataConfig(**kw), shard, shards)
        ref = jx_data.SyntheticLMData(jx_data.DataConfig(**kw), shard,
                                      shards)
        for step in (0, 1, 7):
            for a, b in zip(mine.batch_at(step), ref.batch_at(step)):
                assert a.dtype == b.dtype and np.array_equal(a, b)
        for _ in range(3):
            for a, b in zip(next(mine), next(ref)):
                assert np.array_equal(a, b)
        assert mine.state_dict() == ref.state_dict()
        assert mine.entropy_floor() == ref.entropy_floor()
    if kind == "markov":
        assert np.array_equal(data.markov_transition(97, 3, 5),
                              jx_data.markov_transition(97, 3, 5))


def test_restore_and_reshard_replay_the_stream():
    cfg = data.DataConfig(vocab=50, seq_len=8, global_batch=4, seed=2)
    run = data.SyntheticLMData(cfg)
    for _ in range(5):
        next(run)
    resumed = data.SyntheticLMData(cfg)
    resumed.load_state_dict(run.state_dict())
    assert resumed.step == 5
    assert all(np.array_equal(a, b)
               for a, b in zip(next(resumed), next(run)))
    half = run.reshard(1, 2)
    ref = jx_data.SyntheticLMData(jx_data.DataConfig(**vars(cfg)))
    ref.step = run.step
    for a, b in zip(next(half), next(ref.reshard(1, 2))):
        assert np.array_equal(a, b)
    with pytest.raises(AssertionError, match="seed"):
        resumed.load_state_dict({"step": 0, "seed": 3, "kind": "markov"})


# ---------------------------------------------------------------------------
# fault tolerance: the same decisions on the same inputs
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _heartbeat_trace(pkg):
    clock = _Clock()
    mon = pkg.HeartbeatMonitor([0, 1, 2, 3], timeout_s=10.0, clock=clock)
    out = []
    for t, beats, removed in ((5.0, [0, 1], []), (10.0, [2], []),
                              (15.0, [0], []), (20.5, [1], [3]),
                              (31.0, [], [])):
        clock.t = t
        for h in beats:
            mon.beat(h)
        for h in removed:
            mon.remove(h)
        out.append(mon.dead_hosts())
    return out


def _straggler_trace(pkg):
    det = pkg.StragglerDetector(window=5, threshold=2.0, patience=2)
    durations = [1.0, 1.1, 0.9, 5.0, 1.0, 4.0, 4.5, 1.0, 9.0, 1.2, 1.1,
                 3.0, 3.5, 3.2, 0.1]
    out = []
    for i, d in enumerate(durations):
        flag = det.record(d, host=i % 2)
        out.append((flag, det.should_evict(0), det.should_evict(1),
                    det.median_step_s))
    return out


def _scaler_trace(pkg):
    out = []
    for model_axis, pod in ((16, 256), (4, 32)):
        sc = pkg.ElasticScaler(model_axis=model_axis, pod_chips=pod)
        for up in (1, 3, 16, 31, 255, 256, 511, 512, 1024, 1500):
            plan = sc.plan(up, restore_step=up % 7 or None,
                           dropped_hosts=(up % 5,))
            out.append((plan, plan.n_devices))
    return out


def _restart_trace(pkg):
    fails = {3: 1, 6: 2}
    seen, restores = [], []

    def step_fn(step):
        seen.append(step)
        if fails.get(step, 0):
            fails[step] -= 1
            raise RuntimeError(step)

    def restore_fn(step):
        restores.append(step)
        return step - 1
    out = pkg.run_with_restarts(step_fn, restore_fn, 9, start_step=1,
                                max_restarts=3)
    return out, seen, restores


@pytest.mark.parametrize("trace", [_heartbeat_trace, _straggler_trace,
                                   _restart_trace],
                         ids=["heartbeat", "straggler", "restarts"])
def test_fault_tolerance_decides_as_the_jax_package(trace):
    assert trace(runtime) == trace(jx_runtime)


def test_elastic_scaler_plans_as_the_jax_package():
    def fields(trace):
        return [(p.mesh_shape, p.axis_names, p.restore_step,
                 p.dropped_hosts, n) for p, n in trace]
    assert fields(_scaler_trace(runtime)) == fields(_scaler_trace(jx_runtime))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _tree(rng, scale=1.0):
    return {"embed": rng.standard_normal((6, 4), dtype="float32") * scale,
            "final_norm": rng.standard_normal((4,), dtype="float32") * scale,
            "layers": [{"w": rng.standard_normal((4, 5), dtype="float32")
                        * scale,
                        "b": rng.standard_normal((5,), dtype="float32")
                        * scale * 1e-3} for _ in range(2)]}


def _to_torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(mine, ref, rel=OPT_REL):
    a = [np.asarray(x) for x in jax.tree.leaves(
        jax.tree.map(lambda t: t.numpy(), mine))]
    b = [np.asarray(x) for x in jax.tree.leaves(ref)]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert np.abs(x - y).max() <= rel * max(np.abs(y).max(), 1e-30), (
            np.abs(x - y).max(), np.abs(y).max())


def test_cosine_lr_matches_the_jax_package():
    cfg = optim.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=200,
                            min_lr_frac=0.05)
    jcfg = jx_optim.AdamWConfig(**vars(cfg))
    steps = np.array([0, 1, 5, 10, 11, 57, 105, 199, 200, 500], np.float32)
    mine = optim.cosine_lr(cfg, torch.from_numpy(steps))
    ref = jx_optim.cosine_lr(jcfg, jnp.asarray(steps))
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=OPT_REL,
                               atol=0)
    assert mine.dtype == torch.float32


@pytest.mark.parametrize("grad_scale", [1e-2, 30.0],
                         ids=["unclipped", "clipped"])
def test_adamw_update_matches_the_jax_package(grad_scale):
    """Five AdamW steps on the same fp32 params, grads and state, past the
    warmup: params, moments, lr and grad norm within ``OPT_REL``; the
    count equal; the in-place form bitwise the functional one."""
    rng = np.random.default_rng(11)
    cfg = optim.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6,
                            weight_decay=0.1, clip_norm=1.0)
    jcfg = jx_optim.AdamWConfig(**vars(cfg))
    params = _tree(rng)
    p, jp = _to_torch(params), _to_jax(params)
    state, jstate = optim.adamw_init(p), jx_optim.adamw_init(jp)
    p_in = jax.tree.map(torch.clone, p)
    state_in = optim.adamw_init(p_in)
    for _ in range(5):
        g = _tree(rng, grad_scale)
        p, state, info = optim.adamw_update(cfg, _to_torch(g), state, p)
        jp, jstate, jinfo = jx_optim.adamw_update(cfg, _to_jax(g), jstate,
                                                  jp)
        out = optim.adamw_update(cfg, _to_torch(g), state_in, p_in,
                                 inplace=True)
        assert out[0] is p_in and out[1] is state_in
        _close(p, jp)
        _close(state["m"], jstate["m"])
        _close(state["v"], jstate["v"])
        _close({"lr": info["lr"], "n": info["grad_norm"]},
               {"lr": jinfo["lr"], "n": jinfo["grad_norm"]})
        assert int(state["count"]) == int(jstate["count"])
        for a, b in zip(jax.tree.leaves((p, state)),
                        jax.tree.leaves((p_in, state_in))):
            assert torch.equal(a, b)
    if grad_scale > 1:
        assert float(info["grad_norm"]) > cfg.clip_norm


def test_global_norm_matches_the_jax_package():
    tree = _tree(np.random.default_rng(3))
    np.testing.assert_allclose(
        float(optim.global_norm(_to_torch(tree))),
        float(jx_optim.global_norm(_to_jax(tree))), rtol=OPT_REL)


def test_int8_compression_matches_the_jax_package():
    """q bitwise, scales within 1e-7 relative, over three error-feedback
    steps (the residual carried from step to step)."""
    rng = np.random.default_rng(4)
    grads = _tree(rng)
    q, s = optim.compress_int8(torch.from_numpy(grads["embed"]))
    jq, js = jx_optim.compress_int8(jnp.asarray(grads["embed"]))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert abs(float(s) - float(js)) <= 1e-7 * float(js)
    np.testing.assert_array_equal(
        optim.decompress_int8(q, s).numpy(),
        np.asarray(jx_optim.decompress_int8(jq, js)))
    st = optim.CompressionState.init(_to_torch(grads))
    jst = jx_optim.CompressionState.init(_to_jax(grads))
    for _ in range(3):
        g = _tree(rng)
        qt, st_s, st = optim.error_feedback_compress(_to_torch(g), st)
        jqt, jst_s, jst = jx_optim.error_feedback_compress(_to_jax(g), jst)
        for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                     qt)),
                        jax.tree.leaves(jqt)):
            assert np.array_equal(a, np.asarray(b))
        for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                     st_s)),
                        jax.tree.leaves(jst_s)):
            assert abs(float(a) - float(b)) <= 1e-7 * float(b)
        _close(st.error, jst.error, rel=1e-6)


# ---------------------------------------------------------------------------
# checkpoint store
# ---------------------------------------------------------------------------

def _state(rng):
    params = _to_torch(_tree(rng))
    return {"params": params, "opt": optim.adamw_init(params)}


def test_checkpoint_layout_is_the_jax_packages(tmp_path):
    """The same tree (the port's tensors, the JAX package's arrays) gives
    the same files and meta keys; the port loads what the JAX package
    wrote, bitwise."""
    rng = np.random.default_rng(8)
    tree = _state(rng)
    np_tree = jax.tree.map(lambda t: t.numpy(), tree)
    mine = checkpoint.save_checkpoint(str(tmp_path / "pt"), 3, tree,
                                      extra={"step": 3})
    ref = jx_ckpt.save_checkpoint(str(tmp_path / "jx"), 3,
                                  _to_jax(np_tree), extra={"step": 3})
    assert os.path.basename(mine) == os.path.basename(ref) == "step_00000003"
    assert sorted(os.listdir(mine)) == sorted(os.listdir(ref))
    assert sorted(os.listdir(os.path.join(mine, "arrays"))) == \
        sorted(os.listdir(os.path.join(ref, "arrays")))
    with open(os.path.join(mine, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(ref, "meta.json")) as f:
        jmeta = json.load(f)
    assert meta["extra"] == jmeta["extra"] and meta["step"] == 3
    assert {k: {"shape": v["shape"], "dtype": v["dtype"]}
            for k, v in meta["arrays"].items()} == jmeta["arrays"]
    assert all(v["pspec"] is None for v in meta["arrays"].values())
    loaded, extra = checkpoint.load_checkpoint(str(tmp_path / "jx"), 3, tree)
    assert extra == {"step": 3}
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_commit_protocol_and_async_writer(tmp_path):
    """The writer snapshots before an in-place step can touch the tensors,
    keeps the newest ``keep`` steps, and restore sees committed steps
    only."""
    rng = np.random.default_rng(9)
    d = str(tmp_path)
    assert checkpoint.latest_step(d) is None
    ck = checkpoint.AsyncCheckpointer(d, keep=2)
    tree = _state(rng)
    snap = jax.tree.map(torch.clone, tree)
    ck.save(1, tree, extra={"step": 1})
    for t in jax.tree.leaves(tree):            # an in-place step right after
        t.add_(1)
    ck.wait()
    loaded, extra = checkpoint.load_checkpoint(d, 1, snap)
    assert extra == {"step": 1}
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(snap)):
        assert torch.equal(a, b)
    for s in (2, 3):
        ck.save(s, tree, extra={"step": s})
    ck.wait()
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000003"]
    os.makedirs(os.path.join(d, "step_00000009", "arrays"))  # no COMMITTED
    assert checkpoint.latest_step(d) == 3
    loaded, _ = checkpoint.load_checkpoint(d, 3, snap)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(tree)):
        assert torch.equal(a, b)
    bad = jax.tree.map(lambda t: torch.zeros(t.shape + (1,), dtype=t.dtype),
                       snap)
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_checkpoint(d, 3, bad)
    with pytest.raises(TypeError, match="NamedSharding"):
        checkpoint.load_checkpoint(d, 3, snap, shardings=snap)
