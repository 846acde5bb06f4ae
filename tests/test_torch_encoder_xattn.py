"""The port's encoder-only (audio) and cross-attention (vlm) families
against the JAX package's.

Reduced configs (``ArchConfig.reduced()``: 3 layers, d 64, 4 heads) of
hubert-xlarge with its head dim kept at E = 80 (encoder-only: the frame
embeddings ``frames`` replace the token embedding, attention is
bidirectional and has no rope) and llama-3.2-vision-11b with
``vision_seq`` = 70, which is not S and not a multiple of 64 (layers
``[attn, xattn, attn]``: the ``xattn`` layer's K/V come from the image
embeddings ``img``, non-causal, no rope, no window); identical weights from
JAX ``init_params`` through numpy and ``params_from_numpy``.

Held as ``tests/test_torch_models.py`` holds the dense family: logits and
caches within ``ULPS`` bf16 ulps at the tensor's largest magnitude,
generated tokens equal or parted at a near tie; with the plan's kernel
flags on, the JAX side takes its Pallas attention and MLP in interpret
mode through the ``jax`` stand-in whose ``default_backend()`` answers
"tpu", and the port its kernels' plain versions.

Decode follows the reference as it is: an ``xattn`` layer decodes as an
``attn`` layer does, on a ring cache of its own, and an encoder-only arch
is refused by ``Session.trace("decode")`` (``ValueError``) alone — the JAX
package's decode step and ``generate`` run for it, and so do the port's.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.api as jx_api
from repro.configs import get_config as jx_get
from repro.core.policy import default_plan as jx_default_plan
from repro.launch.serve import greedy_generate as jx_generate
from repro.launch.serve import make_decode_fn as jx_make_decode
from repro.launch.serve import make_prefill_fn as jx_make_prefill
from repro.models import decode_step as jx_decode
from repro.models import forward as jx_forward
from repro.models import init_cache as jx_init_cache
from repro.models import init_params as jx_init_params
from repro.models.transformer import period_structure as jx_periods
import repro.models.transformer as jx_transformer
from repro_torch import kernels
from repro_torch.api import Session
from repro_torch.configs import get_config as pt_get
from repro_torch.core.policy import default_plan as pt_default_plan
from repro_torch.launch import make_prefill_fn
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, params_from_numpy)

#: (registry name, fields replaced in the reduced config)
ARCHS = {"hubert-xlarge": dict(head_dim=80),
         "llama-3.2-vision-11b": dict(vision_seq=70)}
ULPS = 8
NEAR_TIE = 2e-2
S = 40
jx_fused_mlp = importlib.import_module("repro.kernels.fused_mlp")
pt_flash = importlib.import_module("repro_torch.kernels.flash_attention")


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


def _inputs(cfg, B, seed):
    """The family's stubbed embeddings, as (JAX kwargs, port kwargs)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        name, rows = "frames", S
    else:
        name, rows = "img", cfg.vision_seq
    x = rng.standard_normal((B, rows, cfg.d_model)).astype(np.float32)
    return ({name: jnp.asarray(x, jnp.bfloat16)},
            {name: torch.from_numpy(x).to(torch.bfloat16)})


def _jx_layer_caches(jcaches, cfg):
    """The JAX cache tree (period slots stacked, then the remainder) as
    one (k, v) per layer, in layer order."""
    period, n_periods, _ = jx_periods(cfg)
    out = []
    for p_ in range(n_periods):
        for s in range(len(period)):
            k, v = jcaches["periods"][s]
            out.append((k[p_], v[p_]))
    return out + list(jcaches["rest"])


@pytest.mark.parametrize("flags", [False, True],
                         ids=["plain-paths", "kernel-paths"])
def test_prefill_logits_and_caches_match_jax(arch, flags, monkeypatch):
    jplan, pplan = _plans(arch, flags)
    cfg = arch["pcfg"]
    toks = _tokens(arch, (2, S), 0)
    jkw, pkw = _inputs(cfg, 2, 3)
    calls, b5 = [], []
    if flags:
        monkeypatch.setattr(jx_transformer, "jax", _TpuJax())
        for mod, name in ((jx_transformer, "pallas_attention"),
                          (jx_fused_mlp, "fused_mlp")):
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k:
                                calls.append(_n) or _fn(*a, **k))
        flash = pt_flash.flash_attention
        monkeypatch.setattr(
            pt_flash, "flash_attention", lambda q, k, v, **kw:
            b5.append((tuple(q.shape), tuple(k.shape), kw["causal"],
                       kw["window"])) or flash(q, k, v, **kw))
    jlogits, jcaches = jx_forward(arch["jparams"], arch["jcfg"], jplan,
                                  jnp.asarray(toks, jnp.int32),
                                  mode="prefill", **jkw)
    assert set(calls) == ({"pallas_attention", "fused_mlp"} if flags
                          else set())
    before = kernels.launches()
    plogits, pcaches = forward(arch["pparams"], cfg, pplan,
                               torch.from_numpy(toks), **pkw)
    assert kernels.launches() == before          # CPU: plain versions
    assert plogits.shape == (2, S, cfg.padded_vocab)
    assert _bf16_ulps(_np(plogits), _np(jlogits)) <= ULPS
    jlayers = _jx_layer_caches(jcaches, arch["jcfg"])
    kinds = cfg.layer_kinds()
    E = cfg.resolved_head_dim
    for layer, ((k, v), (jk, jv)) in enumerate(zip(pcaches, jlayers)):
        T = cfg.vision_seq if kinds[layer] == "xattn" else S
        assert k.shape == (2, T, cfg.n_kv_heads, E)
        assert _bf16_ulps(_np(k), _np(jk)) <= ULPS
        assert _bf16_ulps(_np(v), _np(jv)) <= ULPS
    if flags:       # B5's forms on this path
        H, KVH = cfg.n_heads, cfg.n_kv_heads
        want = [((2, H, S, E),
                 (2, KVH, cfg.vision_seq if kind == "xattn" else S, E),
                 kind == "attn" and not cfg.encoder_only, None)
                for kind in kinds]
        assert b5 == want


def test_frames_replace_the_token_embedding():
    _, cfg = _configs("hubert-xlarge")
    plan = pt_default_plan(cfg, seq=64)
    params = init_params(cfg, seed=0, device="cpu")
    _, pkw = _inputs(cfg, 2, 3)
    rng = np.random.default_rng(0)
    a, _ = forward(params, cfg, plan,
                   torch.from_numpy(rng.integers(0, cfg.vocab, (2, S))),
                   **pkw)
    b, _ = forward(params, cfg, plan,
                   torch.from_numpy(rng.integers(0, cfg.vocab, (2, S))),
                   **pkw)
    assert torch.equal(a, b)


@pytest.mark.parametrize("flags", [False, True],
                         ids=["plain-paths", "kernel-paths"])
def test_decode_steps_match_jax(arch, flags, monkeypatch):
    """The vlm's ``xattn`` layer decodes on a ring cache of its own, and
    the encoder-only arch runs the decode path, both as in the JAX
    package: each step's logits and the final caches held."""
    jplan, pplan = _plans(arch, flags)
    if flags:
        monkeypatch.setattr(jx_transformer, "jax", _TpuJax())
    cache_len, n_steps = 24, 24
    toks = _tokens(arch, (2, n_steps), 1)
    jstep = jax.jit(jx_make_decode(arch["jcfg"], jplan))
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
    period, n_periods, _ = jx_periods(arch["jcfg"])
    jentries = [{n: a[p_] for n, a in jc["periods"][f"slot{s}"].items()}
                for p_ in range(n_periods) for s in range(len(period))]
    jentries += list(jc["rest"])
    for entry, jentry in zip(pc["layers"], jentries):
        assert entry["k"].shape[1] == cache_len
        np.testing.assert_array_equal(entry["pos_idx"].numpy(),
                                      np.asarray(jentry["pos_idx"]))
        assert _bf16_ulps(_np(entry["k"]), _np(jentry["k"])) <= ULPS
        assert _bf16_ulps(_np(entry["v"]), _np(jentry["v"])) <= ULPS


def test_generate_matches_jax(arch):
    jplan, pplan = _plans(arch, False)
    prompt = _tokens(arch, (2, 6), 1)
    jtoks = np.asarray(jx_generate(arch["jparams"], arch["jcfg"], jplan,
                                   jnp.asarray(prompt, jnp.int32), 10))
    bundle = Session(arch["pcfg"], device="cpu").default_plan(seq=64)
    bundle = dataclasses.replace(bundle, plan=pplan).serve()
    ptoks = bundle.generate(arch["pparams"], torch.from_numpy(prompt),
                            10).numpy()
    assert ptoks.shape == (2, 16)
    np.testing.assert_array_equal(ptoks[:, :6], prompt)
    if np.array_equal(jtoks, ptoks):
        return
    col = int(np.argmax((jtoks != ptoks).any(0)))
    cache = jx_init_cache(arch["jcfg"], 2, 16)
    lg = None
    for t in range(col):
        lg, cache = jx_decode(arch["jparams"], cache, arch["jcfg"], jplan,
                              jnp.asarray(jtoks[:, t:t + 1]), jnp.int32(t))
    lg = np.asarray(lg[:, -1])
    top2 = np.sort(lg, -1)[:, -2:]
    gap = (top2[:, 1] - top2[:, 0]).min()
    assert gap <= NEAR_TIE * np.abs(lg).max(), (col, gap)


def _error(fn):
    try:
        fn()
    except Exception as e:          # noqa: BLE001 - the type is the result
        return type(e).__name__, str(e)
    return None


def test_encoder_only_errors_are_the_references():
    """What the JAX package refuses for an encoder-only arch the port
    refuses with the same error type and message; what it runs, the port
    runs."""
    jcfg, pcfg = _configs("hubert-xlarge")
    got = _error(lambda: Session(pcfg, device="cpu").trace("decode"))
    want = _error(lambda: jx_api.Session(jcfg).trace("decode"))
    assert got == want and got[0] == "ValueError", (got, want)
    assert "encoder-only" in got[1]
    for kw in (dict(kv_len=64), dict(batch=2)):
        got = _error(lambda: Session(pcfg, device="cpu").trace("decode",
                                                               **kw))
        want = _error(lambda: jx_api.Session(jcfg).trace("decode", **kw))
        assert got == want
    # the train and prefill traces of an encoder-only arch are planned
    for phase in ("train", "prefill"):
        assert _error(lambda: Session(pcfg, device="cpu").trace(
            phase, batch=1, seq=64)) is None
        assert _error(lambda: jx_api.Session(jcfg).trace(
            phase, batch=1, seq=64)) is None


def test_prefill_fn_takes_frames_and_img(arch):
    """``make_prefill_fn``'s prefill takes the reference's ``frames`` /
    ``img``."""
    jplan, pplan = _plans(arch, False)
    toks = _tokens(arch, (1, S), 4)
    jkw, pkw = _inputs(arch["pcfg"], 1, 5)
    jl = jx_make_prefill(arch["jcfg"], jplan)(
        arch["jparams"], jnp.asarray(toks, jnp.int32), **jkw)
    pl = make_prefill_fn(arch["pcfg"], pplan)(
        arch["pparams"], torch.from_numpy(toks), **pkw)
    assert _bf16_ulps(_np(pl), _np(jl)) <= ULPS


@pytest.mark.parametrize("name", list(ARCHS))
def test_session_serving_path_on_the_cpu(name):
    """trace -> analyze -> codesign -> lower -> serve() at reduced size,
    the prefill with the family's stubbed embeddings."""
    _, cfg = _configs(name)
    plan = (Session(cfg, device="cpu", use_cache=False)
            .trace("prefill", batch=1, seq=64).analyze().codesign().lower())
    bundle = plan.serve()
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (1, S)))
    _, pkw = _inputs(cfg, 1, 6)
    logits = bundle.prefill_fn(params, toks, **pkw)
    assert logits.shape == (1, S, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())
    if not cfg.encoder_only:
        assert bundle.generate(params, toks[:, :8], 4).shape == (1, 12)
