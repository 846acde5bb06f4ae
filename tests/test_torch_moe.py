"""The port's MoE family against the JAX package's.

Reduced configs of granite-moe-1b-a400m (``ArchConfig.reduced()``: 4
experts, top-2, d 64, expert F 32) and moonshot-v1-16b-a3b (reduced, then
8 experts, top-6); identical weights from JAX ``init_params`` through
numpy and ``params_from_numpy``.

Held as ``tests/test_torch_models.py`` holds the dense family: logits and
caches within ``ULPS`` bf16 ulps at the tensor's largest magnitude,
generated tokens equal or parted at a near tie.  On top of that the
routing is held exactly: every layer's experts (JAX's ``lax.top_k``
indices, recorded through a stand-in for the ``jax`` module inside
``repro.models.moe``), and the slots and keep mask that the reference's
token-major cumsum gives those experts (computed here in numpy), equal the
port's ``route``.  A route that differs is reported with its token and the
probabilities it was chosen from; the seeds are not chosen to avoid one.

The JAX side runs its layers unrolled (``unroll=True``), which evaluates
each layer as the port does.  Its ``lax.scan`` form is another XLA
program: on the reduced granite-moe it disagrees with its own unrolled
form by 22.25 ulps of the logits (6.38 on moonshot; 1.5 on the dense
granite-3-8b), which ``tests/test_models.py::
test_moe_scan_unroll_parity_loose`` puts down to routes that flip on near
ties; the port agreed with the unrolled form within 1.2 ulps when this was
written.  With the plan's kernel flags on, the JAX side takes its Pallas
attention in interpret mode through the ``jax`` stand-in whose
``default_backend()`` answers "tpu"; an MoE layer runs no fused MLP on
either side.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jx_get
from repro.core.policy import default_plan as jx_default_plan
from repro.launch.serve import greedy_generate as jx_generate
from repro.launch.serve import make_decode_fn as jx_make_decode
from repro.models import decode_step as jx_decode
from repro.models import forward as jx_forward
from repro.models import init_cache as jx_init_cache
from repro.models import init_params as jx_init_params
import repro.models.moe as jx_moe
import repro.models.transformer as jx_transformer
import repro_torch.models.moe as pt_moe
from repro_torch import kernels
from repro_torch.api import Session
from repro_torch.configs import get_config as pt_get
from repro_torch.core.policy import default_plan as pt_default_plan
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, params_from_numpy)

#: (registry name, fields replaced in the reduced config)
ARCHS = {"granite-moe-1b-a400m": {},
         "moonshot-v1-16b-a3b": dict(n_experts=8, top_k=6)}
ULPS = 8
NEAR_TIE = 2e-2


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


class _TpuJax:
    """``jax`` as seen by ``repro.models.transformer`` with the kernel path
    selected: ``default_backend()`` says "tpu", everything else is jax."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


class _RecordingJax:
    """``jax`` as seen by ``repro.models.moe``: ``lax.top_k`` records the
    probabilities and the experts it returns."""

    def __init__(self):
        self.routes = []
        outer = self

        class _Lax:
            def __getattr__(self, name):
                return getattr(jax.lax, name)

            @staticmethod
            def top_k(x, k):
                gates, idx = jax.lax.top_k(x, k)
                outer.routes.append((np.asarray(x), np.asarray(idx)))
                return gates, idx
        self.lax = _Lax()

    def __getattr__(self, name):
        return getattr(jax, name)


def _configs(name):
    extra = ARCHS[name]
    return (dataclasses.replace(jx_get(name).reduced(), **extra),
            dataclasses.replace(pt_get(name).reduced(), **extra))


@pytest.fixture(scope="module", params=list(ARCHS))
def arch(request):
    jcfg, pcfg = _configs(request.param)
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(lambda a: np.array(a), jparams)
    return dict(name=request.param, jcfg=jcfg, pcfg=pcfg, jparams=jparams,
                pparams=params_from_numpy(tree, pcfg, device="cpu"))


def _plans(a, flags: bool):
    kw = dict(use_flash_attention=flags, use_fused_mlp=flags)
    jplan = dataclasses.replace(jx_default_plan(a["jcfg"], seq=64), **kw)
    pplan = dataclasses.replace(pt_default_plan(a["pcfg"], seq=64), **kw,
                                use_fused_rmsnorm=flags)
    return jplan, pplan


def _tokens(a, shape, seed):
    return np.random.default_rng(seed).integers(0, a["jcfg"].vocab, shape)


def _reference_slots(idx, n_experts, capacity):
    """The reference's slot assignment for experts ``idx`` (T, k): the
    one-hot cumsum over token-major (token, k) pairs."""
    flat = idx.reshape(-1)
    onehot = np.eye(n_experts, dtype=np.int64)[flat]
    pos = (np.cumsum(onehot, axis=0) * onehot).sum(-1) - 1
    return np.clip(pos, 0, capacity - 1), (pos >= 0) & (pos < capacity)


def _hold_routes(jx_routes, pt_routes, cfg):
    """Every layer's experts equal, then its slots and keep mask; returns
    the dropped (token, k) pairs per layer."""
    assert len(jx_routes) == len(pt_routes) == cfg.n_layers
    dropped = []
    for layer, ((probs, jidx), r) in enumerate(zip(jx_routes, pt_routes)):
        pidx = r.idx.numpy()
        jidx = jidx.reshape(pidx.shape)
        probs = probs.reshape(-1, probs.shape[-1])
        bad = np.flatnonzero((jidx != pidx).any(-1))
        assert not bad.size, (
            f"layer {layer}: {bad.size} tokens routed differently, first "
            f"token {bad[0]}: JAX {jidx[bad[0]]}, port {pidx[bad[0]]}, "
            f"probabilities {probs[bad[0]]}")
        slot, keep = _reference_slots(jidx, cfg.n_experts, r.capacity)
        np.testing.assert_array_equal(r.slot.numpy(), slot)
        np.testing.assert_array_equal(r.keep.numpy(), keep)
        dropped.append(int((~keep).sum()))
    return dropped


@pytest.fixture
def recorded(monkeypatch):
    """Record the routes of both packages' MoE layers."""
    jx = _RecordingJax()
    monkeypatch.setattr(jx_moe, "jax", jx)
    pt_routes = []
    route = pt_moe.route

    def recording_route(*args, **kwargs):
        r = route(*args, **kwargs)
        pt_routes.append(r)
        return r
    monkeypatch.setattr(pt_moe, "route", recording_route)
    return jx.routes, pt_routes


@pytest.mark.parametrize("flags", [False, True],
                         ids=["plain-paths", "kernel-paths"])
def test_prefill_logits_caches_and_routes_match_jax(arch, flags, recorded,
                                                    monkeypatch):
    jplan, pplan = _plans(arch, flags)
    toks = _tokens(arch, (2, 40), 0)
    if flags:
        monkeypatch.setattr(jx_transformer, "jax", _TpuJax())
    jlogits, jcaches = jx_forward(arch["jparams"], arch["jcfg"], jplan,
                                  jnp.asarray(toks, jnp.int32),
                                  mode="prefill", unroll=True)
    before = kernels.launches()
    plogits, pcaches = forward(arch["pparams"], arch["pcfg"], pplan,
                               torch.from_numpy(toks))
    assert kernels.launches() == before          # CPU: plain versions
    assert plogits.shape == (2, 40, arch["pcfg"].padded_vocab)
    dropped = _hold_routes(*recorded, arch["pcfg"])
    # 80 tokens at capacity factor 1.25: granite-moe's reduced model drops
    # pairs, so the keep mask is held where it matters
    if arch["name"] == "granite-moe-1b-a400m":
        assert sum(dropped) > 0, dropped
    assert _bf16_ulps(_np(plogits), _np(jlogits)) <= ULPS
    for layer, (k, v) in enumerate(pcaches):
        jk, jv = jcaches["periods"][layer][0]
        assert _bf16_ulps(_np(k), _np(jk)) <= ULPS
        assert _bf16_ulps(_np(v), _np(jv)) <= ULPS


@pytest.mark.parametrize("flags", [False, True],
                         ids=["plain-paths", "kernel-paths"])
def test_decode_steps_match_jax(arch, flags, monkeypatch):
    jplan, pplan = _plans(arch, flags)
    if flags:
        monkeypatch.setattr(jx_transformer, "jax", _TpuJax())
    cache_len, n_steps = 24, 24
    toks = _tokens(arch, (2, n_steps), 1)
    jstep = jax.jit(jx_make_decode(arch["jcfg"], jplan, unroll=True))
    jc = jx_init_cache(arch["jcfg"], 2, cache_len)
    pc = init_cache(arch["pcfg"], 2, cache_len, device="cpu")
    worst = 0.0
    for t in range(n_steps):
        jl, jc = jstep(arch["jparams"], jc,
                       jnp.asarray(toks[:, t:t + 1], jnp.int32), jnp.int32(t))
        pl, pc = decode_step(arch["pparams"], pc, arch["pcfg"], pplan,
                             torch.from_numpy(toks[:, t:t + 1]), t)
        worst = max(worst, _bf16_ulps(_np(pl), _np(jl)))
    assert worst <= ULPS
    slot = jc["periods"]["slot0"]
    for layer, entry in enumerate(pc["layers"]):
        np.testing.assert_array_equal(entry["pos_idx"].numpy(),
                                      np.asarray(slot["pos_idx"][layer]))
        assert _bf16_ulps(_np(entry["k"]), _np(slot["k"][layer])) <= ULPS
        assert _bf16_ulps(_np(entry["v"]), _np(slot["v"][layer])) <= ULPS


def test_generate_matches_jax(arch):
    jplan, pplan = _plans(arch, True)
    prompt = _tokens(arch, (2, 6), 1)
    jstep = jax.jit(jx_make_decode(arch["jcfg"], jplan, unroll=True))
    jtoks = np.asarray(jx_generate(arch["jparams"], arch["jcfg"], jplan,
                                   jnp.asarray(prompt, jnp.int32), 10,
                                   step_fn=jstep))
    bundle = Session(arch["pcfg"], device="cpu").default_plan(seq=64)
    bundle = dataclasses.replace(bundle, plan=pplan).serve()
    ptoks = bundle.generate(arch["pparams"], torch.from_numpy(prompt),
                            10).numpy()
    assert ptoks.shape == (2, 16)
    if np.array_equal(jtoks, ptoks):
        return
    col = int(np.argmax((jtoks != ptoks).any(0)))
    cache = jx_init_cache(arch["jcfg"], 2, 16)
    lg = None
    for t in range(col):
        lg, cache = jx_decode(arch["jparams"], cache, arch["jcfg"], jplan,
                              jnp.asarray(jtoks[:, t:t + 1]), jnp.int32(t),
                              unroll=True)
    lg = np.asarray(lg[:, -1])
    top2 = np.sort(lg, -1)[:, -2:]
    gap = (top2[:, 1] - top2[:, 0]).min()
    assert gap <= NEAR_TIE * np.abs(lg).max(), (col, gap)


@pytest.mark.parametrize("case", [
    dict(E=4, k=2, act="swiglu", cf=1.25),
    dict(E=8, k=6, act="swiglu", cf=1.25),
    dict(E=4, k=2, act="gelu", cf=1.25),
    dict(E=8, k=2, act="swiglu", cf=0.5)],
    ids=["e4k2", "e8k6", "e4k2-ungated", "e8k2-tight-capacity"])
def test_apply_moe_is_the_reference_bitwise(case):
    """One MoE FFN on identical bf16 inputs: the routes, slots and keep
    mask equal, and the output bitwise equal to the JAX package's (both
    cast, round and sum the same values on the CPU); dropped pairs add
    nothing."""
    D, F, T = 64, 32, 80
    jp = jx_moe.init_moe_params(jax.random.PRNGKey(1), D, F, case["E"],
                                case["act"], jnp.float32)
    pp = {n: torch.from_numpy(np.array(v)) for n, v in jp.items()}
    x = np.random.default_rng(0).standard_normal((T, D)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xp = torch.from_numpy(x).to(torch.bfloat16)
    kw = dict(top_k=case["k"], activation=case["act"],
              capacity_factor=case["cf"])
    yj = np.asarray(jx_moe.apply_moe(jp, xj, **kw).astype(jnp.float32))
    yp = pt_moe.apply_moe(pp, xp, **kw)
    assert yp.dtype == torch.bfloat16 and yp.shape == (T, D)
    np.testing.assert_array_equal(yp.float().numpy(), yj)
    r = pt_moe.route(pp["w_router"], xp, top_k=case["k"],
                     capacity_factor=case["cf"])
    assert r.capacity == pt_moe.capacity(T, case["E"], case["k"], case["cf"])
    assert r.capacity == max(case["k"],
                             int(T * case["k"] * case["cf"]) // case["E"])
    logits = jnp.asarray(x, jnp.bfloat16).astype(jnp.float32) @ jp["w_router"]
    _, jidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), case["k"])
    np.testing.assert_array_equal(r.idx.numpy(), np.asarray(jidx))
    slot, keep = _reference_slots(np.asarray(jidx), case["E"], r.capacity)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    if case["cf"] < 1:
        assert not keep.all()
        # a token all of whose pairs were dropped comes out zero
        none_kept = ~keep.reshape(T, case["k"]).any(-1)
        assert none_kept.any()
        assert not yp[torch.from_numpy(none_kept)].float().abs().sum()


def test_apply_moe_reads_nothing_on_the_host():
    """On the meta device every op runs on shapes alone: a ``nonzero``,
    a boolean-mask index or an ``.item()`` would raise.  That is what a
    decode step captured into a CUDA graph needs of the MoE layer."""
    cfg = pt_get("granite-moe-1b-a400m").reduced()
    gen = torch.Generator()
    params = pt_moe.init_moe_params(gen, 64, 32, 4, "swiglu", device="cpu")
    params = {n: v.to("meta") for n, v in params.items()}
    x = torch.empty((6, 64), dtype=torch.bfloat16, device="meta")
    y = pt_moe.apply_moe(params, x, top_k=cfg.top_k, activation="swiglu")
    assert y.shape == (6, 64) and y.device.type == "meta"


def test_params_from_numpy_carries_the_experts(arch):
    cfg, p = arch["pcfg"], arch["pparams"]
    mine = init_params(cfg, seed=3, device="cpu")
    assert len(p["layers"]) == len(mine["layers"]) == cfg.n_layers
    gated = "w_gate" in arch["jparams"]["periods"]["slot0"]["moe"]
    shapes = {"w_router": (cfg.d_model, cfg.n_experts),
              "w_up": (cfg.n_experts, cfg.d_model, cfg.d_ff),
              "w_down": (cfg.n_experts, cfg.d_ff, cfg.d_model)}
    if gated:
        shapes["w_gate"] = shapes["w_up"]
    for i, (got, ref) in enumerate(zip(p["layers"], mine["layers"])):
        assert "mlp" not in got and "mlp" not in ref
        assert {n: tuple(t.shape) for n, t in got["moe"].items()} == \
            {n: tuple(t.shape) for n, t in ref["moe"].items()} == shapes
        for n in shapes:
            np.testing.assert_array_equal(
                got["moe"][n].numpy(),
                np.asarray(arch["jparams"]["periods"]["slot0"]["moe"][n][i]))


def test_session_serving_path_on_the_cpu():
    """trace -> analyze -> codesign -> lower -> serve() on a reduced
    granite-moe: the plan turns B6 on, but an MoE layer runs no B6."""
    cfg = pt_get("granite-moe-1b-a400m").reduced()
    plan = (Session(cfg, device="cpu", use_cache=False)
            .trace("prefill", batch=1, seq=64).analyze().codesign().lower())
    bundle = plan.serve()
    params = init_params(cfg, seed=0, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (3, 8)))
    logits = bundle.prefill_fn(params, prompt)
    assert logits.shape == (3, 8, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())
    assert bundle.generate(params, prompt, 5).shape == (3, 13)
