"""The port's training step against the JAX package's: loss and gradients.

Reduced configs (``ArchConfig.reduced()``: 3 layers, d 64) of granite-3-8b
and minitron-8b here, gemma-7b and h2o-danube-1.8b in
``test_torch_train_more_archs.py`` (the same tests), identical weights
from JAX ``init_params`` through ``params_from_numpy``, one batch of 2 x 40 tokens made from a seed with
numpy; the plans' ``kv_block`` is 16, so chunked attention runs three kv
blocks, the last ragged, and h2o-danube's 32-token window bites.

Both packages differentiate the same plain forms (module docstring of
``repro_torch.models.autograd``): with the plan's flags off, naive
attention, the plain MLP and the plain norm on both sides; with them on,
the port's forward goes through its three autograd Functions (their
plain versions on the CPU: split-P attention, the 3xTF32 MLP, the B7
norm) and backward through ``chunked_flash_attention``, the plain MLP and
``rms_norm``, where the JAX package runs ``chunked_flash_attention`` and
the plain MLP and norm both ways.  Each runs in bf16 with fp32 sums in
its own order, so bf16 roundings flip and carry through the backward:
JAX's own ``TrainConfig(unroll=True)`` and ``unroll=False`` steps part
by up to 1.5e-2 of a leaf's gradient norm (readings at writing: 1.22e-2
to 1.47e-2 as the largest leaf over the archs and flags).  A leaf's
gradient is held to ``max(1e-3, 2 x that spread)`` of its norm, measured
in the test; the port read 1.21 to 1.46 times the spread at writing.
The loss is held to ``max(1e-3, 2 x its spread)`` relative (readings: at
most 3.3e-4 against spreads of 2.3e-5 to 1.9e-4).  A mask, scale or
missing gradient path moves a leaf by its own norm.
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
from repro.launch.train import TrainConfig as JxTrainConfig
from repro.launch.train import make_loss_fn as jx_make_loss_fn
from repro.models import init_params as jx_init_params
from repro_torch.configs import get_config as pt_get
from repro_torch.core.policy import default_plan as pt_default_plan
from repro_torch.launch.train import (TrainConfig, make_loss_fn,
                                      value_and_grad)
from repro_torch.models import params_from_numpy

ARCHS = ["granite-3-8b", "minitron-8b"]
BATCH, SEQ, KV_BLOCK = 2, 40, 16
#: the least relative tolerance of the loss and of a leaf's gradient
MIN_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these shapes are tiny, and the suite runs in
    parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_arch(name):
    """Configs, weights and one batch of ``name``, in both packages."""
    jcfg = jx_get(name).reduced()
    pcfg = pt_get(name).reduced()
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab,
                                             (BATCH, SEQ + 1))
    return dict(jcfg=jcfg, pcfg=pcfg, jparams=jparams,
                pparams=params_from_numpy(jax.tree.map(np.array, jparams),
                                          pcfg, device="cpu"),
                jbatch={"tokens": jnp.asarray(toks[:, :-1]),
                        "labels": jnp.asarray(toks[:, 1:])},
                pbatch={"tokens": torch.from_numpy(toks[:, :-1]),
                        "labels": torch.from_numpy(toks[:, 1:])})


@pytest.fixture(scope="module", params=ARCHS)
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
    """{leaf path: |got - want| / |want|} in the 2-norm."""
    want_leaves = dict((pytree.keystr(p), w) for p, w in
                       pytree.tree_flatten_with_path(want)[0])
    out = {}
    for p, g in pytree.tree_flatten_with_path(got)[0]:
        w = want_leaves[pytree.keystr(p)].double()
        out[pytree.keystr(p)] = float((g.double() - w).norm() / w.norm())
    return out


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
    for g in pytree.tree_leaves(grads):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        assert bool((g != 0).any())


@pytest.mark.parametrize("flags", [False, True],
                         ids=["plain-forms", "kernel-functions"])
def test_forward_goes_through_the_kernel_functions(arch, flags):
    """With the flags on, the graph holds the three Functions' backward
    nodes (and, plain, none of them); every parameter reaches the loss."""
    _, pplan = _plans(arch, flags)
    params = pytree.tree_map(lambda p: p.detach().requires_grad_(True),
                             arch["pparams"])
    loss = make_loss_fn(arch["pcfg"], pplan, TrainConfig(remat=False))(
        params, arch["pbatch"])
    names = _graph_nodes(loss)
    functions = {"FlashAttentionFnBackward", "FusedMLPFnBackward",
                 "RMSNormFnBackward"}
    assert (functions <= names) if flags else not (functions & names), names
    loss.backward()
    for path, p in pytree.tree_flatten_with_path(params)[0]:
        assert p.grad is not None and bool((p.grad != 0).any()), \
            pytree.keystr(path)
