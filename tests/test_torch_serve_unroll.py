"""``unroll=`` on the port's LLM serving API.

The JAX package takes ``unroll`` on ``CompiledPlan.serve``,
``make_serving``, ``make_prefill_fn``, ``make_decode_fn`` and
``jit_decode_step`` and keeps it as ``ServeBundle.unroll``
(``repro/launch/serve.py``); there it swaps the layer period's
``lax.scan`` for a Python loop.  The port always walks the layers in a
Python loop and captures a decode step into one graph, so the keyword is
accepted everywhere, kept on the bundle and passed to the bundle's own
functions, and changes no output: prefill logits and ``generate`` tokens
are bitwise those of ``unroll=False``, at a 2-layer config of each
family the port serves.
"""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

import repro.launch.serve as jx_serve
from repro_torch.api import Session
from repro_torch.configs import get_config
from repro_torch.launch import serve as pt_serve
from repro_torch.models import init_params

ENTRY_POINTS = ["make_serving", "make_prefill_fn", "make_decode_fn",
                "jit_decode_step"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_take_unroll_as_the_reference_does(name):
    ours = inspect.signature(getattr(pt_serve, name)).parameters["unroll"]
    ref = inspect.signature(getattr(jx_serve, name)).parameters["unroll"]
    assert ours.kind == ref.kind == inspect.Parameter.KEYWORD_ONLY
    assert ours.default is ref.default is False
    field = {f.name: f for f in dataclasses.fields(pt_serve.ServeBundle)}
    assert field["unroll"].default is False


def _bundle_pair(arch, kind=None):
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=2)
    compiled = (Session(cfg, device="cpu")
                .trace("prefill", batch=1, seq=32, layer_kind=kind)
                .analyze().codesign().lower())
    return cfg, compiled, compiled.serve(), compiled.serve(unroll=True)


@pytest.mark.parametrize("arch,kind", [("granite-3-8b", None),
                                       ("recurrentgemma-2b", "attn"),
                                       ("rwkv6-7b", None)])
def test_unroll_changes_no_output(arch, kind):
    cfg, compiled, rolled, unrolled = _bundle_pair(arch, kind)
    assert (rolled.unroll, unrolled.unroll) == (False, True)
    params = init_params(cfg, seed=0, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 6)))
    assert torch.equal(rolled.prefill_fn(params, prompt),
                       unrolled.prefill_fn(params, prompt))
    toks = rolled.generate(params, prompt, 4)
    assert torch.equal(toks, unrolled.generate(params, prompt, 4))
    # the bundle's decode step carries the keyword into its step function
    step = unrolled.jit_decode(None, 2, 10)
    assert step is unrolled.jit_decode(None, 2, 10)
    cache = pt_serve.init_cache(cfg, 2, 10, device="cpu")
    cache_u = pt_serve.init_cache(cfg, 2, 10, device="cpu")
    tok = prompt[:, :1]
    a, _ = pt_serve.make_decode_fn(cfg, compiled.plan)(params, cache, tok, 0)
    b, _ = pt_serve.make_decode_fn(cfg, compiled.plan, unroll=True)(
        params, cache_u, tok, 0)
    assert torch.equal(a, b)
    c, _ = pt_serve.jit_decode_step(cfg, compiled.plan, None, 2, 10,
                                    unroll=True)(
        params, pt_serve.init_cache(cfg, 2, 10, device="cpu"), tok, 0)
    assert torch.equal(a, c)
    assert torch.equal(
        pt_serve.make_prefill_fn(cfg, compiled.plan, unroll=True)(
            params, prompt), rolled.prefill_fn(params, prompt))
    assert pt_serve.make_serving(cfg, compiled.plan, unroll=True) == unrolled
