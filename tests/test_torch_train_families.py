"""The port's training step against the JAX package's for the families
beyond the dense one: loss and gradients.

Reduced configs (``ArchConfig.reduced()``: 3 layers, d 64) of
granite-moe-1b-a400m (moe: 4 experts, top-2), recurrentgemma-2b (hybrid:
``[rglru, rglru, attn]``, window 32) and rwkv6-7b (ssm: three ``rwkv``
layers) here, hubert-xlarge (audio, E 80) and llama-3.2-vision-11b (vlm,
``vision_seq`` 70) in ``test_torch_train_families_more.py`` (the same
tests), identical weights from JAX ``init_params`` through
``params_from_numpy``, and one batch of 2 x 40 tokens made from a seed with
numpy, with its ``frames`` (audio) or ``img`` (vlm) stub drawn from the
same numpy generator and fed to both packages.  At 40 steps the B8 scan
runs one ragged chunk of its 64 and B9 two chunks of 16 and a ragged one.

As ``tests/test_torch_train.py`` holds the dense family: both packages
differentiate the same plain forms (B5-B7 under their Functions where the
plan's flags are on); the recurrences run B8/B9 under ``RGLRUFn`` /
``WKV6Fn`` in the port (their plain versions on the CPU forward, the
chunked plain forms backward) and JAX's ``lax.scan`` references.  A
leaf's gradient is held to ``max(1e-3, 2 x`` JAX's own ``unroll=True`` /
``unroll=False`` spread ``)`` of its norm, measured in the test (readings
at writing: spreads of 9.2e-3 to 1.7e-2, the port at 1.0 to 1.8 times
them), the loss to ``max(1e-3, 2 x its spread)`` relative.  An audio
model's token embedding gets no gradient in either package (the frames
replace it): it is held to be zero in both.

The MoE routes are data: the JAX package's ``lax.scan`` and unrolled
forms route a near tie differently (``tests/test_torch_moe.py``), and one
moved (token, k) pair moves every later slot of its two experts.  So the
routes of the port's training forward are also held equal to the JAX
package's (its unrolled forward, recorded by a stand-in for ``jax`` inside
``repro.models.moe``), slots and keep masks included, on the plain forms,
which both packages run.  With the kernel flags on, the port's forward
runs the kernels' plain versions (split-P attention, the B7 norm) where
JAX runs its plain forms, and at writing one token of layer 2 took its two
experts in the other order (probabilities 0.39071 and 0.39100); the
gradients still held within the limit above.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import jax
import jax.numpy as jnp
import repro.models.moe as jx_moe
import repro_torch.models.moe as pt_moe
from repro.configs import get_config as jx_get
from repro.core.policy import default_plan as jx_default_plan
from repro.launch.train import TrainConfig as JxTrainConfig
from repro.launch.train import make_loss_fn as jx_make_loss_fn
from repro.models import forward as jx_forward
from repro.models import init_params as jx_init_params
from repro_torch.configs import get_config as pt_get
from repro_torch.core.policy import default_plan as pt_default_plan
from repro_torch.launch.train import (TrainConfig, make_loss_fn,
                                      value_and_grad)
from repro_torch.models import params_from_numpy
from test_torch_moe import _hold_routes, _RecordingJax

#: (registry name, fields replaced in the reduced config)
ARCHS = {"granite-moe-1b-a400m": {}, "recurrentgemma-2b": {},
         "rwkv6-7b": {}, "hubert-xlarge": dict(head_dim=80),
         "llama-3.2-vision-11b": dict(vision_seq=70)}
BATCH, SEQ, KV_BLOCK = 2, 40, 16
#: the least relative tolerance of the loss and of a leaf's gradient
MIN_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_arch(name):
    """Configs, weights and one batch of ``name``, stubs included, in both
    packages."""
    extra = ARCHS[name]
    jcfg = dataclasses.replace(jx_get(name).reduced(), **extra)
    pcfg = dataclasses.replace(pt_get(name).reduced(), **extra)
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab, (BATCH, SEQ + 1))
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]),
              "labels": jnp.asarray(toks[:, 1:])}
    pbatch = {"tokens": torch.from_numpy(toks[:, :-1]),
              "labels": torch.from_numpy(toks[:, 1:])}
    stub = {"audio": ("frames", SEQ), "vlm": ("img", jcfg.vision_seq)}
    if jcfg.family in stub:
        key, rows = stub[jcfg.family]
        arr = rng.standard_normal((BATCH, rows, jcfg.d_model),
                                  dtype=np.float32)
        jbatch[key] = jnp.asarray(arr, jnp.bfloat16)
        pbatch[key] = torch.from_numpy(arr).to(torch.bfloat16)
    return dict(name=name, jcfg=jcfg, pcfg=pcfg, jparams=jparams,
                pparams=params_from_numpy(jax.tree.map(np.array, jparams),
                                          pcfg, device="cpu"),
                jbatch=jbatch, pbatch=pbatch)


@pytest.fixture(scope="module",
                params=["granite-moe-1b-a400m", "recurrentgemma-2b",
                        "rwkv6-7b"])
def arch(request):
    return make_arch(request.param)


def _plans(a, flags):
    kw = dict(use_flash_attention=flags, use_fused_mlp=flags,
              kv_block=KV_BLOCK)
    return (dataclasses.replace(jx_default_plan(a["jcfg"], seq=SEQ), **kw),
            dataclasses.replace(pt_default_plan(a["pcfg"], seq=SEQ), **kw,
                                use_fused_rmsnorm=flags))


def _jax_grads(a, plan, unroll):
    fn = jax.jit(jax.value_and_grad(jx_make_loss_fn(
        a["jcfg"], plan, JxTrainConfig(unroll=unroll))))
    loss, grads = fn(a["jparams"], a["jbatch"])
    return float(loss), params_from_numpy(jax.tree.map(np.array, grads),
                                          a["pcfg"], device="cpu")


def _leaf_rel(got, want):
    """{leaf path: |got - want| / |want|} in the 2-norm; a leaf whose
    reference is zero reads 0 if ``got``'s is zero too, else inf."""
    want_leaves = dict((pytree.keystr(p), w) for p, w in
                       pytree.tree_flatten_with_path(want)[0])
    out = {}
    for p, g in pytree.tree_flatten_with_path(got)[0]:
        w = want_leaves[pytree.keystr(p)].double()
        d = float((g.double() - w).norm())
        n = float(w.norm())
        out[pytree.keystr(p)] = d / n if n else (0.0 if d == 0 else np.inf)
    return out


def _unused(a):
    """Leaves no loss reaches: an audio model's token embedding."""
    return {"['embed']"} if a["pcfg"].family == "audio" else set()


@pytest.mark.parametrize("flags", [False, True],
                         ids=["plain-forms", "kernel-functions"])
def test_loss_and_gradients_match_jax(arch, flags):
    jplan, pplan = _plans(arch, flags)
    loss_ref, grads_ref = _jax_grads(arch, jplan, unroll=False)
    loss_alt, grads_alt = _jax_grads(arch, jplan, unroll=True)
    loss, grads = value_and_grad(make_loss_fn(arch["pcfg"], pplan,
                                              TrainConfig()))(
        arch["pparams"], arch["pbatch"])
    loss_tol = max(MIN_TOL, 2 * abs(loss_alt - loss_ref) / abs(loss_ref))
    assert abs(float(loss) - loss_ref) <= loss_tol * abs(loss_ref), (
        float(loss), loss_ref, loss_tol)
    spread = max(_leaf_rel(grads_alt, grads_ref).values())
    tol = max(MIN_TOL, 2 * spread)
    errs = _leaf_rel(grads, grads_ref)
    assert max(errs.values()) <= tol, (tol, sorted(
        errs.items(), key=lambda kv: -kv[1])[:3])
    for path, g in pytree.tree_flatten_with_path(grads)[0]:
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        assert bool((g != 0).any()) != (pytree.keystr(path) in
                                        _unused(arch)), pytree.keystr(path)


def _graph_nodes(t):
    seen, todo, names = set(), [t.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


@pytest.mark.parametrize("flags", [False, True],
                         ids=["plain-forms", "kernel-functions"])
def test_forward_goes_through_the_kernel_functions(arch, flags):
    """The graph holds the Functions of the kernels the model runs: B8/B9's
    always (their sequence forms have no plain path), B5-B7's with the
    plan's flags on (B6 only where an MLP runs: an MoE layer runs none),
    none of them with the flags off; every used parameter reaches the
    loss."""
    _, pplan = _plans(arch, flags)
    cfg = arch["pcfg"]
    kinds = set(cfg.layer_kinds())
    always = ({"RGLRUFnBackward"} if "rglru" in kinds else set()) | (
        {"WKV6FnBackward"} if "rwkv" in kinds else set())
    flagged = {"RMSNormFnBackward"}
    if kinds & {"attn", "xattn"}:
        flagged.add("FlashAttentionFnBackward")
    if not cfg.is_moe:
        flagged.add("FusedMLPFnBackward")
    params = pytree.tree_map(lambda p: p.detach().requires_grad_(True),
                             arch["pparams"])
    loss = make_loss_fn(cfg, pplan, TrainConfig(remat=False))(
        params, arch["pbatch"])
    names = _graph_nodes(loss)
    assert always <= names, names
    functions = {"FlashAttentionFnBackward", "FusedMLPFnBackward",
                 "RMSNormFnBackward"}
    assert (flagged <= names) if flags else not (functions & names), names
    loss.backward()
    for path, p in pytree.tree_flatten_with_path(params)[0]:
        if pytree.keystr(path) in _unused(arch):
            assert p.grad is None
            continue
        assert p.grad is not None and bool((p.grad != 0).any()), \
            pytree.keystr(path)


def test_moe_training_routes_match_jax(monkeypatch):
    """The port's training forward routes every (token, k) pair of the
    batch as the JAX package's does, slots and keep masks included."""
    a = make_arch("granite-moe-1b-a400m")
    jplan, pplan = _plans(a, False)
    jx = _RecordingJax()
    monkeypatch.setattr(jx_moe, "jax", jx)
    jx_forward(a["jparams"], a["jcfg"], jplan, a["jbatch"]["tokens"],
               mode="train", unroll=True)
    routes = []
    route = pt_moe.route

    def recording_route(*args, **kwargs):
        routes.append(route(*args, **kwargs))
        return routes[-1]
    monkeypatch.setattr(pt_moe, "route", recording_route)
    params = pytree.tree_map(lambda p: p.detach().requires_grad_(True),
                             a["pparams"])
    make_loss_fn(a["pcfg"], pplan, TrainConfig())(
        params, a["pbatch"]).backward()
    # the forward routes once a layer; the remat recompute routes again,
    # from the last layer back
    n = a["pcfg"].n_layers
    assert len(routes) == 2 * n
    _hold_routes(jx.routes, routes[:n], a["pcfg"])
    for r, again in zip(routes[:n], routes[:n - 1:-1]):
        assert torch.equal(r.idx, again.idx) and torch.equal(r.slot,
                                                             again.slot)
