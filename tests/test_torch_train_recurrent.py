"""B8 and B9 under autograd, remat of the recurrent families, and a short
training loop of one of them.

* ``RGLRUFn`` and ``WKV6Fn`` (``repro_torch.models.autograd``) alone
  against ``jax.grad`` of the JAX package's ``lax.scan`` references
  (``rglru_reference``, ``wkv6_reference``): random cotangents for the
  sequence output, and for the final state too or not at all (the loss of
  a model gives it none), the initial state given, S not a multiple of the
  chunk (100 = 64 + 36 for B8, 37 = 16 + 16 + 5 for B9); gradients to
  every input, ``a_param`` / ``u`` and the initial state included.  fp32:
  within ``GRAD_TOL`` = 1e-5 of the leaf's largest magnitude (the two
  forms sum the same fp32 terms in their own orders; readings at writing
  up to 1.6e-6); bf16 inputs: their gradients are one bf16 rounding of
  those fp32 values (``_bf16_close``), the fp32 leaves within ``GRAD_TOL``.
* Remat of reduced recurrentgemma-2b (hybrid) and rwkv6-7b (ssm), the
  plan's kernel flags on: gradients with the plan's policy (``attn_out``,
  ``mlp_out``, ``rnn_state``), with nothing saveable and without remat are
  bitwise equal, and the policy keeps exactly its names' tensors,
  ``rnn_state`` included, as ``test_torch_train_remat.py`` holds them for
  the dense family.
* Four steps of ``train_loop`` on reduced recurrentgemma-2b track the JAX
  package's four (as ``test_torch_train_loop.py`` for the dense family).
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import jax
import jax.numpy as jnp
from repro.configs import get_config as jx_get
from repro.core.policy import default_plan as jx_default_plan
from repro.data import DataConfig as JxDataConfig
from repro.data import SyntheticLMData as JxSyntheticLMData
from repro.kernels.rglru import rglru_reference as jx_rglru_ref
from repro.kernels.rwkv6 import wkv6_reference as jx_wkv6_ref
from repro.launch.train import AdamWConfig as JxAdamWConfig
from repro.launch.train import train_loop as jx_train_loop
from repro.models import init_params as jx_init_params
from repro_torch.configs import get_config
from repro_torch.core.policy import default_plan
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.launch.train import (TrainConfig, make_loss_fn,
                                      train_loop, value_and_grad)
from repro_torch.models import forward, init_params, params_from_numpy
from repro_torch.models.autograd import RGLRUFn, WKV6Fn
from repro_torch.models.common import RematPolicy
from repro_torch.optim import AdamWConfig
from test_torch_recurrent_kernels import _bf16_close, _close

GRAD_TOL = 1e-5
#: a step's loss, port against JAX, relative (``test_torch_train_loop``)
LOSS_REL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(rng, shape, dtype, scale=1.0, shift=0.0):
    """The same values for both packages: (jax array, torch leaf)."""
    a = (rng.standard_normal(shape) * scale + shift).astype(np.float32)
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    j = jnp.asarray(a, jdt)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return j, t.requires_grad_(True)


def _hold_grads(got, want, dtypes):
    for g, w, dt in zip(got, want, dtypes):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        if dt == "bf16":
            assert g.dtype == torch.bfloat16
            _bf16_close(g.float().numpy(), w, GRAD_TOL)
        else:
            assert g.dtype == torch.float32
            _close(g.numpy(), w, GRAD_TOL)


@pytest.mark.parametrize("state_grad", [False, True],
                         ids=["output-only", "output-and-state"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_rglru_fn_gradients_match_jax(dtype, state_grad):
    rng = np.random.default_rng(5)
    B, S, D = 2, 100, 48
    x, gr, gi = (_pair(rng, (B, S, D), dtype) for _ in range(3))
    a_param = _pair(rng, (D,), "fp32", 0.05, 1.0)
    h0 = _pair(rng, (B, D), "fp32")
    gy = rng.standard_normal((B, S, D)).astype(np.float32)
    gh = rng.standard_normal((B, D)).astype(np.float32)
    ins = (x, gr, gi, a_param, h0)

    def loss(*args):
        h, hT = jx_rglru_ref(*args)
        out = (h.astype(jnp.float32) * gy).sum()
        return out + (hT * gh).sum() if state_grad else out
    want = jax.grad(loss, argnums=tuple(range(5)))(*(j for j, _ in ins))
    h, hT = RGLRUFn.apply(*(t for _, t in ins))
    out = (h.float() * torch.from_numpy(gy)).sum()
    if state_grad:
        out = out + (hT * torch.from_numpy(gh)).sum()
    got = torch.autograd.grad(out, [t for _, t in ins])
    _hold_grads(got, want, (dtype,) * 3 + ("fp32",) * 2)


@pytest.mark.parametrize("state_grad", [False, True],
                         ids=["output-only", "output-and-state"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_wkv6_fn_gradients_match_jax(dtype, state_grad):
    rng = np.random.default_rng(6)
    B, H, S, E = 2, 2, 37, 16
    r, k, v = (_pair(rng, (B, H, S, E), dtype, 0.5) for _ in range(3))
    w = _pair(rng, (B, H, S, E), "fp32", 0.5, -0.5)
    u = _pair(rng, (H, E), "fp32", 0.1)
    s0 = _pair(rng, (B, H, E, E), "fp32", 0.3)
    gy = rng.standard_normal((B, H, S, E)).astype(np.float32)
    gs = rng.standard_normal((B, H, E, E)).astype(np.float32)
    ins = (r, k, v, w, u, s0)

    def loss(*args):
        y, sT = jx_wkv6_ref(*args)
        out = (y.astype(jnp.float32) * gy).sum()
        return out + (sT * gs).sum() if state_grad else out
    want = jax.grad(loss, argnums=tuple(range(6)))(*(j for j, _ in ins))
    y, sT = WKV6Fn.apply(*(t for _, t in ins))
    out = (y.float() * torch.from_numpy(gy)).sum()
    if state_grad:
        out = out + (sT * torch.from_numpy(gs)).sum()
    got = torch.autograd.grad(out, [t for _, t in ins])
    _hold_grads(got, want, (dtype,) * 3 + ("fp32",) * 3)


def test_fns_without_an_initial_state_or_a_gradient():
    """Without h0/s0 the Functions take None and give it no gradient; an
    output that is not used backpropagates nothing."""
    rng = np.random.default_rng(7)
    x, gr, gi = (torch.from_numpy(rng.standard_normal((1, 20, 8))
                                  .astype(np.float32)).requires_grad_()
                 for _ in range(3))
    a_param = torch.full((8,), 1.0, requires_grad=True)
    h, _ = RGLRUFn.apply(x, gr, gi, a_param, None)
    grads = torch.autograd.grad(h.sum(), [x, a_param])
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    _, hT = RGLRUFn.apply(x, gr, gi, a_param, None)
    assert bool((torch.autograd.grad(hT.sum(), x)[0] != 0).any())
    r, k, v, w = (torch.from_numpy(rng.standard_normal((1, 2, 20, 8))
                                   .astype(np.float32)).requires_grad_()
                  for _ in range(4))
    u = torch.zeros((2, 8), requires_grad=True)
    y, _ = WKV6Fn.apply(r, k, v, w, u, None)
    gu = torch.autograd.grad(y.sum(), u)[0]
    assert gu.shape == u.shape and bool((gu != 0).any())


# ---------------------------------------------------------------------------
# remat of the recurrent families
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["recurrentgemma-2b", "rwkv6-7b"])
def model(request):
    cfg = get_config(request.param).reduced()
    plan = dataclasses.replace(default_plan(cfg, seq=40), kv_block=16)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 41)))
    return dict(cfg=cfg, plan=plan,
                params=init_params(cfg, seed=0, device="cpu"),
                batch={"tokens": toks[:, :-1], "labels": toks[:, 1:]})


def test_remat_gradients_are_bitwise(model):
    plan = model["plan"]
    assert plan.remat_save_names == ("attn_out", "mlp_out", "rnn_state")
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


def test_policy_keeps_exactly_its_names(model):
    """The policy's cache holds the tagged tensors of its names, one a
    layer each, and nothing else: ``rnn_state`` is the scan's output of an
    ``rglru`` layer (B, S, D) bf16 or an ``rwkv`` layer (B, H, S, E)
    bf16."""
    cfg = model["cfg"]
    B, S = model["batch"]["tokens"].shape
    bsd = B * S * cfg.d_model * 2
    kinds = cfg.layer_kinds()
    attn = sum(k == "attn" for k in kinds)
    rnn = len(kinds) - attn
    E = cfg.resolved_head_dim
    per_layer = {"attn_out": (attn, bsd), "mlp_out": (len(kinds), bsd),
                 "x_mid": (len(kinds), bsd), "rnn_state": (rnn, bsd),
                 "q_out": (attn, B * S * cfg.n_heads * E * 2)}
    params = pytree.tree_map(lambda p: p.detach().requires_grad_(True),
                             model["params"])
    for names in (("rnn_state",), ("x_mid", "rnn_state"), tuple(per_layer),
                  model["plan"].remat_save_names):
        policy = RematPolicy(names)
        forward(params, cfg, model["plan"], model["batch"]["tokens"],
                mode="train", remat_policy=policy)
        want = len(kinds) * bsd + sum(n * size for n, size in
                                      (per_layer[k] for k in names))
        assert policy.saved_bytes == want, (names, policy.saved_bytes, want)


# ---------------------------------------------------------------------------
# the training loop of a recurrent family
# ---------------------------------------------------------------------------

def test_four_steps_track_the_jax_package():
    name = "recurrentgemma-2b"
    jcfg, cfg = jx_get(name).reduced(), get_config(name).reduced()
    jparams = jx_init_params(jax.random.PRNGKey(3), jcfg)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    data = dict(vocab=jcfg.vocab, seq_len=16, global_batch=4, seed=0)
    ref = jx_train_loop(jcfg, jx_default_plan(jcfg, seq=16),
                        JxAdamWConfig(**kw),
                        data_iter=iter(JxSyntheticLMData(JxDataConfig(
                            **data))), n_steps=4, params=jparams,
                        log_every=0)
    out = train_loop(cfg, default_plan(cfg, seq=16), AdamWConfig(**kw),
                     data_iter=iter(SyntheticLMData(DataConfig(**data))),
                     n_steps=4, params=params_from_numpy(
                         jax.tree.map(np.array, jparams), cfg,
                         device="cpu"), log_every=0)
    want = [h["loss"] for h in ref["history"]]
    got = [h["loss"] for h in out["history"]]
    assert np.allclose(got, want, rtol=LOSS_REL, atol=0), (got, want)
    assert int(out["opt_state"]["count"]) == int(ref["opt_state"]["count"])
