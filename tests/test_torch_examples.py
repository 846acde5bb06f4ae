"""The port's user entry points, ``examples/torch_*.py``, held against
their JAX twins in ``examples/``.

Each port script runs in this process through ``main(argv)`` with
``--device cpu`` (its kernels' plain versions) at a small size; its JAX
twin runs in this process too, through its ``main()`` with ``sys.argv``
set to the same flags, its printed lines captured and, where it keeps
its answers to itself, its answers recorded by wrapping the JAX API call
that returns them.  Where the JAX example draws weights or a prompt with
``jax.random``, the port script is given the same numbers (its
``init_params`` / ``make_prompt`` patched to the JAX draws), as the
other parity tests do with ``params_from_numpy``.

Tolerances: plans and span names equal; solver answers within
``FP32_REL`` / ``FP32_ABS`` (the cross-package table of
``tests/test_torch_exec.py``: the port's kernels' plain versions against
the JAX package's, fp32); training losses within ``LOSS_REL`` (as
``tests/test_torch_train_loop.py``); generated tokens equal; a restored
run against the port's own uninterrupted run bitwise.
"""
import contextlib
import importlib.util
import io
import json
import pathlib
import re
import sys

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import jax

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
SCRIPTS = ("hpc_cg", "quickstart", "observe_cg", "serve_cg", "serve_batch",
           "serve_chaos", "train_lm", "elastic_restart")

#: solver answers, port (plain versions of the kernels) against the JAX
#: package, fp32: relative to the output's scale, with an absolute floor
FP32_REL, FP32_ABS = 2e-4, 1e-5
#: a training step's loss, port against JAX, relative (see
#: ``tests/test_torch_train_loop.py``: the two differentiate the same
#: forms in bf16 with sums in their own orders)
LOSS_REL = 1e-3


def _load(name, alias):
    spec = importlib.util.spec_from_file_location(alias, EXAMPLES / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port(name):
    return _load(f"torch_{name}.py", f"torch_{name}")


def run_jax(name, argv, monkeypatch):
    """The JAX example's ``main()`` on ``argv``; returns its stdout."""
    mod = _load(f"{name}.py", f"jx_example_{name}")
    monkeypatch.setattr(sys, "argv", [str(EXAMPLES / f"{name}.py"), *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    return buf.getvalue()


def run_port(name, argv):
    """The port script's ``main(argv + --device cpu)``; returns (its
    result, its stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = port(name).main([*argv, "--device", "cpu"])
    return out, buf.getvalue()


def recording(cls, method, sink):
    """``cls.method`` wrapped to append each call's return value to
    ``sink``."""
    fn = getattr(cls, method)

    def wrapper(*args, **kw):
        ret = fn(*args, **kw)
        sink.append(ret)
        return ret
    return wrapper


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= max(FP32_REL * scale, FP32_ABS), (what, err, scale)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_codesign_cache(monkeypatch):
    monkeypatch.setenv("CELLO_NO_CACHE", "1")


# ---------------------------------------------------------------------------
# the solver scripts
# ---------------------------------------------------------------------------

def test_hpc_cg_solution_and_residual_match_jax(monkeypatch):
    """cg(n=256, iters=4): the port's ``cuda`` outputs (x4, r4) against
    the JAX example's ``pallas`` outputs (Pallas interpret mode), the
    printed residual norm equal to 4 digits, the ``reference`` backend
    bitwise the natural-order oracle in both."""
    from repro.api.artifacts import CompiledPlan as JxPlan
    argv = ["--n", "256", "--iters", "4"]
    runs = []
    monkeypatch.setattr(JxPlan, "run", recording(JxPlan, "run", runs))
    jx_out = run_jax("hpc_cg", argv, monkeypatch)
    out, text = run_port("hpc_cg", argv)
    jx_pallas = {k: np.asarray(v) for k, v in runs[-1].items()}
    assert sorted(out["outputs"]) == sorted(jx_pallas) == ["r4", "x4"]
    for k in jx_pallas:
        _close(out["outputs"][k], jx_pallas[k], k)
    want = re.search(r"final CG residual norm: (\S+)", jx_out).group(1)
    assert f"{out['residual_norm']:.4g}" == want
    assert out["max_abs_diff"]["reference"] == 0.0
    assert "[reference] vs natural-order oracle: max abs diff = 0 " in jx_out
    assert out["max_abs_diff"]["cuda"] <= FP32_ABS
    # the printed stages equal the JAX example's but for the backend names
    for stage in ("traced", "analyzed", "codesign"):
        line = re.search(rf"^{stage} +: .*$", jx_out, re.M).group(0)
        assert line in text, stage


QUICKSTART = [["--seq", "512"],
              ["--arch", "rwkv6-7b", "--phase", "prefill", "--seq", "1024"],
              ["--arch", "gemma-7b", "--phase", "decode", "--batch", "8",
               "--seq", "4096", "--strategy", "greedy"]]


@pytest.mark.parametrize("argv", QUICKSTART,
                         ids=["granite-train", "rwkv6-prefill",
                              "gemma-decode-greedy"])
def test_quickstart_plan_matches_jax_field_for_field(argv, monkeypatch):
    """The lowered plan equal field for field, and every printed line
    equal; the port's ``explain()`` adds one line, B7's flag (``fused
    RMSNorm``), which the JAX package's plan has as a field but does not
    print."""
    from repro.api.artifacts import CoDesigned as JxCoDesigned
    import dataclasses
    plans = []
    monkeypatch.setattr(JxCoDesigned, "lower",
                        recording(JxCoDesigned, "lower", plans))
    jx_out = run_jax("quickstart", [*argv, "--no-cache"], monkeypatch)
    out, text = run_port("quickstart", [*argv, "--no-cache"])
    assert out["plan"] == dataclasses.asdict(plans[-1].plan)
    mine = [ln for ln in text.splitlines()
            if not ln.startswith("  fused RMSNorm     :")]
    assert mine == jx_out.splitlines()
    assert f"  fused RMSNorm     : {out['plan']['use_fused_rmsnorm']}" in text


def test_observe_cg_trace_loads_with_the_jax_span_names(tmp_path,
                                                        monkeypatch):
    """Each package's chrome trace loads as JSON and holds the same span
    names, the kernel backends on both sides (``cuda``, ``pallas``); the
    port's also holds its run's three stages under ``exec.dispatch``."""
    import repro.obs as jx_obs
    from repro_torch import obs
    for mod in (jx_obs, obs):              # spans of earlier tests go
        monkeypatch.setattr(mod, "_SINKS", [])
        mod.tracer().clear()
    try:
        run_jax("observe_cg", ["--n", "64", "--iters", "2", "--backend",
                               "pallas", "--trace", str(tmp_path / "j.json")],
                monkeypatch)
        out, text = run_port("observe_cg", [
            "--n", "64", "--iters", "2", "--trace",
            str(tmp_path / "t.json")])
    finally:
        for mod in (jx_obs, obs):
            mod.disable()
            mod.tracer().clear()
    names = []
    for f in ("j.json", "t.json"):
        with open(tmp_path / f) as fh:
            names.append({e["name"] for e in json.load(fh)["traceEvents"]})
    assert names[0] | {"exec.feed", "exec.replay", "exec.copy_out"} == \
        names[1]
    assert {"session.trace", "session.analyze", "session.codesign",
            "session.lower", "codesign.search", "exec.compile",
            "exec.dispatch", "example.run"} <= names[1]
    assert set(out["span_names"]) == names[1]
    assert out["spans_written"] > 0
    assert "all four pipeline stage spans recorded: verified" in text


def test_serve_cg_answers_match_jax(monkeypatch):
    """Every answer of the same burst (cg and cg_sparse, n=64, 4 requests
    each, batches of 4, and the explicit right-hand side): the port's
    lane forms (``cuda``) against the JAX example's ``reference`` backend,
    the same batch sizes, buckets and per-bucket stats."""
    import repro.serve.server as jx_server
    futs = []
    monkeypatch.setattr(jx_server.Server, "submit",
                        recording(jx_server.Server, "submit", futs))
    argv = ["--n", "64", "--requests", "4", "--max-batch", "4"]
    jx_out = run_jax("serve_cg", argv, monkeypatch)
    out, text = run_port("serve_cg", argv)
    jx_res = [f.result() for f in futs]
    assert len(out["results"]) == len(jx_res) == 9
    for mine, ref in zip(out["results"], jx_res):
        assert mine["bucket"].rsplit("/", 1)[0] == \
            ref.bucket.rsplit("/", 1)[0]
        assert mine["batch_size"] == ref.batch_size
        assert mine["backend"] == "cuda" and not mine["degraded"]
        assert sorted(mine["outputs"]) == sorted(ref.outputs)
        for k in ref.outputs:
            _close(mine["outputs"][k], np.asarray(ref.outputs[k]), k)
        assert mine["residual"] == pytest.approx(ref.residual, rel=FP32_REL)
    assert "one dispatch per coalesced batch: verified" in text
    jx_stats = [ln.replace("/reference", "") for ln in jx_out.splitlines()
                if "requests=" in ln]
    assert [ln.replace("/cuda", "") for ln in text.splitlines()
            if "requests=" in ln] == jx_stats


def test_serve_chaos_same_outcomes_as_jax(monkeypatch):
    """The same three incidents: every request of incident 1 served
    degraded by the reference fallback with the same fallbacks, retries
    and breaker state; incident 2's offered load split into served and
    rejected (the split is timing: both parts non-empty); incident 3's
    crash typed and one supervised restart."""
    jx_out = run_jax("serve_chaos", [], monkeypatch)
    out, text = run_port("serve_chaos", [])
    m = re.search(r"served=(\d+) degraded, fallbacks=(\d+), retries=(\d+), "
                  r"breaker\[.*\]=(\w+)", jx_out)
    i1 = out["incident1"]
    assert len(i1["requests"]) == int(m.group(1))
    assert all(r["degraded"] and r["backend"] == "reference"
               for r in i1["requests"])
    assert (i1["fallbacks"], i1["retries"], i1["breaker"]) == (
        int(m.group(2)), int(m.group(3)), m.group(4))
    assert i1["health"] == re.search(r"health: (\w+)", jx_out).group(1)
    m = re.search(r"offered=(\d+) served=(\d+) rejected fast\+typed=(\d+)",
                  jx_out)
    i2 = out["incident2"]
    assert i2["offered"] == int(m.group(1)) == int(m.group(2)) + \
        int(m.group(3))
    assert i2["served"] + i2["rejected"] == i2["offered"]
    assert i2["served"] > 0 and i2["rejected"] > 0
    m = re.search(r"failed typed: (\w+)\n.*batch=(\d+)\), health=(\w+), "
                  r"worker_restarts=(\d+)", jx_out)
    i3 = out["incident3"]
    assert (i3["crashed"], i3["batch_size"], i3["health"],
            i3["worker_restarts"]) == (m.group(1), int(m.group(2)),
                                       m.group(3), int(m.group(4)))
    assert text.splitlines()[-1] == jx_out.splitlines()[-1]


# ---------------------------------------------------------------------------
# the LLM scripts
# ---------------------------------------------------------------------------

def _jax_params_for_port(jcfg, cfg, seed=0):
    from repro.models import init_params as jx_init_params
    from repro_torch.models import params_from_numpy
    jparams = jx_init_params(jax.random.PRNGKey(seed), jcfg)
    return jparams, params_from_numpy(jax.tree.map(np.array, jparams), cfg,
                                      device="cpu")


def test_serve_batch_generates_the_jax_tokens(monkeypatch):
    """Reduced granite-3-8b, batch 2, prompt 4, 4 new tokens: with the JAX
    example's weights and prompt, the port's generated tokens equal the
    JAX example's, every row."""
    from repro.configs import get_config as jx_get
    from repro.launch.serve import ServeBundle as JxBundle
    from repro_torch.configs import get_config
    gens = []
    monkeypatch.setattr(JxBundle, "generate",
                        recording(JxBundle, "generate", gens))
    argv = ["--batch", "2", "--prompt-len", "4", "--new-tokens", "4"]
    jx_out = run_jax("serve_batch", argv, monkeypatch)
    jcfg = jx_get("granite-3-8b").reduced()
    _, params = _jax_params_for_port(jcfg, get_config("granite-3-8b")
                                     .reduced())
    prompt = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 4), 0,
                                           jcfg.vocab))
    mod = port("serve_batch")
    monkeypatch.setattr(mod, "init_params", lambda cfg, seed, device: params)
    monkeypatch.setattr(mod, "make_prompt", lambda b, p, v, device:
                        torch.tensor(prompt, dtype=torch.long))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = mod.main([*argv, "--device", "cpu"])
    assert np.array_equal(out["tokens"], np.asarray(gens[-1]))
    row = re.search(r"sample row    : (.*)", jx_out).group(1)
    assert f"{out['tokens'][0].tolist()}" == row
    for line in ("arch          :", "generated     :"):
        assert re.search(rf"^{line}.*$", jx_out, re.M).group(0) in \
            buf.getvalue()


def test_serve_batch_prompt_is_the_same_on_every_device():
    mod = port("serve_batch")
    a = mod.make_prompt(3, 5, 128, "cpu")
    b = mod.make_prompt(3, 5, 128, "meta")
    assert a.shape == b.shape == (3, 5) and a.dtype == torch.long
    assert bool((a >= 0).all() and (a < 128).all())
    assert torch.equal(a, mod.make_prompt(3, 5, 128, "cpu"))


def test_train_lm_losses_track_the_jax_example(tmp_path, monkeypatch):
    """The tiny preset, 3 steps, the JAX example's initial weights: each
    step's loss within ``LOSS_REL`` of the JAX example's; no checkpoint
    yet in either (the first comes at step 50)."""
    from repro.configs import get_config as jx_get
    import dataclasses
    import repro.launch.train as jx_train
    import repro_torch.launch.train as pt_train
    hist = []
    monkeypatch.setattr(jx_train, "train_loop",
                        recording(jx_train, "train_loop", hist))
    run_jax("train_lm", ["--steps", "3", "--ckpt-dir", str(tmp_path / "j")],
            monkeypatch)
    L, D, H, KV, F, V, B, S = port("train_lm").PRESETS["tiny"]
    jcfg = dataclasses.replace(
        jx_get("granite-3-8b"), n_layers=L, d_model=D, n_heads=H,
        n_kv_heads=KV, head_dim=D // H, d_ff=F, vocab=V, name="granite-tiny")
    inner = pt_train.train_loop

    def with_jax_weights(cfg, *a, **kw):
        kw["params"] = _jax_params_for_port(jcfg, cfg, kw.pop("seed", 0))[1]
        return inner(cfg, *a, **kw)
    monkeypatch.setattr(pt_train, "train_loop", with_jax_weights)
    out, text = run_port("train_lm", ["--steps", "3", "--ckpt-dir",
                                      str(tmp_path / "t")])
    want = [h["loss"] for h in hist[-1]["history"]]
    assert len(out["losses"]) == len(want) == 3
    assert np.allclose(out["losses"], want, rtol=LOSS_REL, atol=0), \
        (out["losses"], want)
    assert out["latest_checkpoint"] is None
    assert not (tmp_path / "j").exists() or not any((tmp_path / "j")
                                                   .iterdir())
    assert text.splitlines()[:2] == [
        "model: granite-tiny  params≈0.1M",
        "data: markov synthetic, loss floor ≈ 1.386 nats (uniform would be "
        "6.238)"]


def _steps(text):
    return [(int(s), float(v), int(d)) for s, v, d in re.findall(
        r"step +(\d+)  loss (\S+)  devices=(\d+)", text)]


def test_elastic_restart_across_a_failure(tmp_path, monkeypatch):
    """8 steps failed at step 5, restored from step 4, with the JAX
    example's initial weights: every step's loss (the replayed ones too)
    within ``LOSS_REL`` of the JAX example's, the same restores and fleet;
    against the port's own uninterrupted run, every loss and every final
    leaf bitwise; every restored leaf on the state's device with the dtype
    its checkpoint recorded."""
    from repro.configs import get_config as jx_get
    from repro_torch.configs import get_config
    argv = ["--steps", "8", "--fail-at", "5"]
    jx_out = run_jax("elastic_restart", [*argv, "--ckpt-dir",
                                         str(tmp_path / "j")], monkeypatch)
    _, params = _jax_params_for_port(jx_get("granite-3-8b").reduced(),
                                     get_config("granite-3-8b").reduced())
    mod = port("elastic_restart")
    monkeypatch.setattr(mod, "init_params", lambda cfg, seed, device:
                        pytree.tree_map(torch.clone, params))
    runs = {}
    for label, fail in (("crash", ["--fail-at", "5"]), ("straight",
                                                        ["--fail-at"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            runs[label] = mod.main(["--steps", "8", *fail, "--ckpt-dir",
                                    str(tmp_path / label), "--device",
                                    "cpu"])
        runs[label]["text"] = buf.getvalue()
    crash, straight = runs["crash"], runs["straight"]
    want = _steps(jx_out)
    got = [(s["step"], s["loss"], s["devices"]) for s in crash["steps"]]
    assert [(s, d) for s, _, d in got] == [(s, d) for s, _, d in want]
    assert [s for s, _, _ in got] == [0, 1, 2, 3, 4, 4, 5, 6, 7]
    assert np.allclose([v for _, v, _ in got], [v for _, v, _ in want],
                       rtol=LOSS_REL, atol=0)
    assert _steps(crash["text"]) == [(s, float(f"{v:.4f}"), d)
                                     for s, v, d in got]
    assert re.findall(r"!! restoring .*", crash["text"]) == \
        re.findall(r"!! restoring .*", jx_out)
    assert crash["text"].splitlines()[-1] == jx_out.splitlines()[-1]
    # against the uninterrupted run
    by_step = {s["step"]: s["loss"] for s in straight["steps"]}
    assert straight["restarts"] == 0 and len(by_step) == 8
    assert all(s["loss"] == by_step[s["step"]] for s in crash["steps"])
    for a, b in zip(pytree.tree_leaves(crash["state"]),
                    pytree.tree_leaves(straight["state"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    (r,) = crash["restores"]
    assert (r["failed_step"], r["step"]) == (5, 4)
    assert {d for d, _ in r["leaves"]} == {"cpu"}
    assert [dt for _, dt in r["leaves"]] == r["saved_dtypes"]
    assert crash["kept_steps"] == [4, 8] and crash["keep"] == 3


# ---------------------------------------------------------------------------
# every script
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SCRIPTS)
def test_script_raises_without_a_card_and_never_falls_back(name,
                                                           monkeypatch):
    """``--device cuda`` is the default: without CUDA the script raises
    before any work, as ``Session()`` does, and prints no result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            pytest.raises(RuntimeError, match="CUDA is not available"):
        port(name).main([])
    assert "verified" not in buf.getvalue()
    assert "completed" not in buf.getvalue()


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_keeps_the_jax_examples_flags(name):
    """Every flag of the JAX example, with its default, plus ``--device``
    (default ``cuda``).  The solver scripts' ``--backend`` defaults to the
    port's kernel backend, ``cuda``, where the JAX example's defaults to
    ``reference``; the elastic demo's ``--ckpt-dir`` to a new temporary
    directory, and train_lm's to one under the temporary directory of the
    process, where the JAX examples name ``/tmp`` paths."""
    import argparse
    parsers = []

    def grab(self, *a, **kw):
        parsers.append(self)
        raise SystemExit(0)
    flags = []
    for mod in (_load(f"{name}.py", f"jx_flags_{name}"), port(name)):
        orig = argparse.ArgumentParser.parse_args
        argparse.ArgumentParser.parse_args = grab
        try:
            with pytest.raises(SystemExit):
                mod.main() if mod.__name__.startswith("jx_") else \
                    mod.main([])
        finally:
            argparse.ArgumentParser.parse_args = orig
        flags.append({a.dest: a.default for a in parsers[-1]._actions
                      if a.dest != "help"})
    jx, mine = flags
    assert mine.pop("device") == "cuda"
    changed = {"backend": ("reference", "cuda"), "ckpt_dir": None}
    for k, v in jx.items():
        assert k in mine, k
        if k in changed:
            continue
        assert mine[k] == v, (k, mine[k], v)
    assert set(mine) == set(jx)
    if "backend" in jx:
        assert (jx["backend"], mine["backend"]) == changed["backend"]
