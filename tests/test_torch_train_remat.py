"""The port's training step on its own: the remat policy, micro-batch
accumulation and the ``CompiledPlan.train`` entry point.

Reduced granite-3-8b (3 layers, d 64) and minitron-8b, the plan's kernel
flags on, so the forward runs the three autograd Functions (their plain
versions on the CPU); one batch of 2 x 40 tokens from a numpy seed."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro_torch.api import Session
from repro_torch.configs import get_config
from repro_torch.core.policy import default_plan
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.launch.train import (TrainConfig, cross_entropy,
                                      make_loss_fn, make_train_step,
                                      value_and_grad)
from repro_torch.models import forward, init_params
from repro_torch.models.common import RematPolicy
from repro_torch.optim import AdamWConfig, adamw_init

ARCHS = ["granite-3-8b", "minitron-8b"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = get_config(request.param).reduced()
    plan = dataclasses.replace(default_plan(cfg, seq=40), kv_block=16)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 41)))
    return dict(cfg=cfg, plan=plan,
                params=init_params(cfg, seed=0, device="cpu"),
                batch={"tokens": toks[:, :-1], "labels": toks[:, 1:]})


def _saved_bytes(m, policy):
    """Bytes a training forward keeps for its backward: what autograd packs
    outside checkpointed regions (``saved_tensors_hooks``; parameters,
    which exist anyway, left out; each storage once), plus what the remat
    policy keeps (regions' inputs and kept tags)."""
    kept = {}

    def pack(t):
        if not (t.is_leaf and t.requires_grad):
            st = t.untyped_storage()
            kept[st.data_ptr()] = st.nbytes()
        return t
    params = pytree.tree_map(lambda p: p.detach().requires_grad_(True),
                             m["params"])
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        logits, _ = forward(params, m["cfg"], m["plan"], m["batch"]["tokens"],
                            mode="train", remat_policy=policy)
        cross_entropy(logits, m["batch"]["labels"])
    return sum(kept.values()) + (policy.saved_bytes if policy else 0)


def test_remat_gradients_are_bitwise_and_save_less(model):
    """Gradients with the plan's policy (``attn_out``, ``mlp_out``), with
    nothing saveable and without remat are bitwise equal; the saved bytes
    order nothing < the plan's names < no remat."""
    plan = model["plan"]
    assert plan.remat_save_names == ("attn_out", "mlp_out")
    runs = {}
    for name, names, remat in (("none", (), True),
                               ("plan", plan.remat_save_names, True),
                               ("off", None, False)):
        p = dataclasses.replace(plan, remat_save_names=names or ())
        runs[name] = value_and_grad(make_loss_fn(
            model["cfg"], p, TrainConfig(remat=remat)))(model["params"],
                                                        model["batch"])
    for name in ("none", "plan"):
        assert torch.equal(runs[name][0], runs["off"][0])
        for a, b in zip(pytree.tree_leaves(runs[name][1]),
                        pytree.tree_leaves(runs["off"][1])):
            assert torch.equal(a, b), name
    nothing = _saved_bytes(model, RematPolicy(()))
    named = _saved_bytes(model, plan.checkpoint_policy())
    full = _saved_bytes(model, None)
    assert nothing < named < full, (nothing, named, full)
    # the plan's names keep two (B, S, D) bf16 tensors a layer more
    B, S = model["batch"]["tokens"].shape
    assert named - nothing == 2 * model["cfg"].n_layers * B * S \
        * model["cfg"].d_model * 2


def test_policy_keeps_exactly_its_names(model):
    """The policy's cache holds the tagged tensors of its names, one a
    layer each, and nothing else."""
    cfg = model["cfg"]
    B, S = model["batch"]["tokens"].shape
    bsd = B * S * cfg.d_model * 2
    region_inputs = cfg.n_layers * bsd
    plain = dataclasses.replace(model["plan"], use_flash_attention=False,
                                use_fused_mlp=False)
    E = cfg.resolved_head_dim
    sizes = {"attn_out": bsd, "mlp_out": bsd, "x_mid": bsd,
             "q_out": B * S * cfg.n_heads * E * 2,
             "mlp_hidden": B * S * cfg.d_ff * 2}
    params = pytree.tree_map(lambda p: p.detach().requires_grad_(True),
                             model["params"])
    for names in (("q_out",), ("x_mid", "mlp_hidden"), tuple(sizes)):
        policy = RematPolicy(names)
        forward(params, cfg, plain, model["batch"]["tokens"], mode="train",
                remat_policy=policy)
        want = region_inputs + cfg.n_layers * sum(sizes[n] for n in names)
        assert policy.saved_bytes == want, (names, policy.saved_bytes, want)
    assert model["plan"].checkpoint_policy().save_names == \
        frozenset(("attn_out", "mlp_out"))
    assert RematPolicy(()).save_names == frozenset()


def test_accum_steps_match_the_full_batch(model):
    """accum=2 over a split batch == accum=1 over the full batch, to the
    JAX package's own limits (``tests/test_distributed.py``)."""
    cfg, plan = model["cfg"], model["plan"]
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, weight_decay=0.0)
    ds = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=16,
                                    global_batch=8, seed=1))
    x, y = next(ds)
    batch = {"tokens": torch.from_numpy(x), "labels": torch.from_numpy(y)}
    out = []
    for a in (1, 2):
        step = make_train_step(cfg, plan, opt,
                               TrainConfig(accum_steps=a, donate=False))
        params = model["params"]
        out.append(step(params, adamw_init(params), batch))
    (p1, _, m1), (p2, _, m2) = out
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=2e-3)
    for a, b in zip(pytree.tree_leaves(p1), pytree.tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-3,
                                   rtol=5e-3)


def test_donated_step_is_bitwise_the_functional_one(model):
    cfg, plan = model["cfg"], model["plan"]
    opt = AdamWConfig(lr=1e-3, warmup_steps=1)
    params = pytree.tree_map(torch.clone, model["params"])
    state = adamw_init(params)
    p_f, s_f, m_f = make_train_step(cfg, plan, opt, TrainConfig(
        donate=False))(model["params"], adamw_init(model["params"]),
                       model["batch"])
    p_d, s_d, m_d = make_train_step(cfg, plan, opt, TrainConfig(
        donate=True))(params, state, model["batch"])
    assert p_d is params and s_d is state
    for a, b in zip(pytree.tree_leaves((p_f, s_f, m_f)),
                    pytree.tree_leaves((p_d, s_d, m_d))):
        assert torch.equal(a, b)


def test_compiled_plan_trains_on_the_cpu_and_refuses_the_rest():
    """``CompiledPlan.train`` runs the dense family (three steps) and each
    of the other five (two steps: moe, hybrid, ssm, audio on stubbed
    frames, vlm on a stubbed image) on the CPU; only an HPC plan is
    refused."""
    cfg = get_config("granite-3-8b").reduced()
    plan = Session(cfg, device="cpu").default_plan(seq=16)
    ds = iter(SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=16,
                                         global_batch=2)))
    out = plan.train(data_iter=ds, n_steps=3, log_every=0)
    assert [h["step"] for h in out["history"]] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert int(out["opt_state"]["count"]) == 3
    assert all(t.device.type == "cpu"
               for t in pytree.tree_leaves(out["params"]))
    hpc = (Session(device="cpu").trace(workload="cg", n=64, iters=2)
           .analyze().codesign().lower())
    with pytest.raises(ValueError, match="HPC"):
        hpc.train(data_iter=ds, n_steps=1)
    for name in ("granite-moe-1b-a400m", "recurrentgemma-2b", "rwkv6-7b",
                 "hubert-xlarge", "llama-3.2-vision-11b"):
        other = get_config(name).reduced()
        data = iter(SyntheticLMData(DataConfig(vocab=other.vocab, seq_len=16,
                                               global_batch=2)))
        out = Session(other, device="cpu").default_plan(seq=16).train(
            data_iter=data, n_steps=2, log_every=0)
        losses = [h["loss"] for h in out["history"]]
        assert len(losses) == 2 and all(np.isfinite(v) for v in losses), (
            name, losses)
        assert int(out["opt_state"]["count"]) == 2, name
        assert all(t.device.type == "cpu" and bool(torch.isfinite(t).all())
                   for t in pytree.tree_leaves(out["params"])), name
