"""The port's observability layer, ``repro_torch.obs``: the cases of
``tests/test_obs.py`` run against the port's copy (metrics registry,
streaming histograms, span tracer, export schemas, the zero-overhead
disabled path), then parity with ``repro.obs``: the same operations give
equal snapshots and quantiles in both packages, a port export passes the
JAX package's validators, and a span shows in a CPU ``torch.profiler``
trace.

Quantile policy under test (docs/observability.md): streaming histograms
estimate p50/p90/p99 within ``HIST_REL_ERROR`` (±5%) relative error of the
nearest-rank sample quantile, with exact count/sum/min/max.
"""
import json
import subprocess
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

import repro.obs as jx_obs
from repro_torch import obs
from repro_torch.obs.metrics import (HIST_REL_ERROR, MetricsRegistry,
                                     merge_summaries, next_scope)
from repro_torch.obs import tracing
from repro_torch.obs.tracing import (JSONL_KEYS, SpanTracer, load_jsonl,
                                     validate_chrome, validate_jsonl)


# ---------------------------------------------------------------------------
# counters / gauges / label isolation
# ---------------------------------------------------------------------------

class TestCounters:
    def test_counter_counts_and_labels_are_isolated(self):
        reg = MetricsRegistry()
        c = reg.counter("reqs", "requests")
        c.inc(bucket="a")
        c.inc(2.0, bucket="a")
        c.inc(bucket="b")
        assert c.value(bucket="a") == 3.0
        assert c.value(bucket="b") == 1.0
        assert c.value(bucket="never-bumped") == 0.0

    def test_counter_is_monotonic(self):
        reg = MetricsRegistry()
        with pytest.raises(ValueError, match="only go up"):
            reg.counter("c").inc(-1.0)

    def test_get_or_define_returns_same_instrument(self):
        reg = MetricsRegistry()
        assert reg.counter("x", "first help") is reg.counter("x")

    def test_kind_mismatch_raises(self):
        reg = MetricsRegistry()
        reg.counter("x")
        with pytest.raises(TypeError, match="already defined as counter"):
            reg.histogram("x")

    def test_scope_labels_never_alias_across_instances(self):
        # the pattern every instrumented object uses: one shared registry
        # definition, per-object exactness via a unique scope label
        reg = MetricsRegistry()
        c = reg.counter("dispatches")
        s1, s2 = next_scope("t"), next_scope("t")
        assert s1 != s2
        c.inc(scope=s1)
        c.inc(scope=s1)
        c.inc(scope=s2)
        assert c.value(scope=s1) == 2.0
        assert c.value(scope=s2) == 1.0

    def test_gauge_set_and_add(self):
        reg = MetricsRegistry()
        g = reg.gauge("depth")
        g.set(5, q="a")
        g.add(-2, q="a")
        assert g.value(q="a") == 3.0


# ---------------------------------------------------------------------------
# streaming histograms
# ---------------------------------------------------------------------------

class TestHistograms:
    def test_quantiles_within_documented_error_of_numpy(self):
        rng = np.random.default_rng(7)
        samples = rng.lognormal(mean=-6.0, sigma=1.2, size=5000)
        reg = MetricsRegistry()
        h = reg.histogram("lat", unit="s")
        for x in samples:
            h.observe(float(x))
        for q in (0.50, 0.90, 0.99):
            est = h.quantile(q)
            # nearest-rank sample quantile — the documented reference point
            exact = float(np.percentile(samples, q * 100,
                                        method="inverted_cdf"))
            assert abs(est - exact) / exact <= HIST_REL_ERROR + 1e-9, \
                f"p{q * 100:g}: {est} vs {exact}"

    def test_exact_count_sum_min_max(self):
        reg = MetricsRegistry()
        h = reg.histogram("h")
        xs = [0.003, 0.5, 12.0, 0.0001]
        for x in xs:
            h.observe(x)
        s = h.summary()
        assert s["count"] == 4
        assert s["sum"] == pytest.approx(sum(xs))
        assert s["min"] == min(xs) and s["max"] == max(xs)
        assert s["min"] <= s["p50"] <= s["max"]

    def test_empty_summary(self):
        reg = MetricsRegistry()
        s = reg.histogram("h").summary()
        assert s == {"count": 0, "sum": 0.0, "mean": None, "min": None,
                     "max": None, "p50": None, "p90": None, "p99": None}

    def test_zero_and_negative_go_to_underflow(self):
        reg = MetricsRegistry()
        h = reg.histogram("h")
        for x in (0.0, -1.0, 0.0):
            h.observe(x)
        s = h.summary()
        assert s["count"] == 3 and s["min"] == -1.0
        assert s["p50"] == 0.0    # underflow quantile reports "no time"

    def test_quantile_bounds_checked(self):
        reg = MetricsRegistry()
        with pytest.raises(ValueError, match=r"\[0, 1\]"):
            reg.histogram("h").quantile(1.5)

    def test_merge_summaries(self):
        reg = MetricsRegistry()
        h = reg.histogram("h")
        for x in (1.0, 2.0):
            h.observe(x, k="a")
        h.observe(10.0, k="b")
        merged = merge_summaries([h.summary(k="a"), h.summary(k="b")])
        assert merged["count"] == 3
        assert merged["sum"] == pytest.approx(13.0)
        assert merged["min"] == 1.0 and merged["max"] == 10.0


# ---------------------------------------------------------------------------
# registry: snapshot shape, scope filter, thread safety
# ---------------------------------------------------------------------------

class TestRegistry:
    def test_snapshot_shape_and_scope_filter(self):
        reg = MetricsRegistry()
        reg.counter("c", "help text", unit="B").inc(3, scope="s1")
        reg.counter("c").inc(5, scope="s2")
        reg.histogram("h").observe(0.25, scope="s1")
        snap = reg.snapshot()
        assert snap["c"]["kind"] == "counter"
        assert snap["c"]["help"] == "help text"
        assert snap["c"]["unit"] == "B"
        assert {c["labels"]["scope"]: c["value"]
                for c in snap["c"]["cells"]} == {"s1": 3.0, "s2": 5.0}
        assert snap["h"]["cells"][0]["value"]["count"] == 1
        only = reg.snapshot("s1")
        assert [c["labels"] for c in only["c"]["cells"]] == [{"scope": "s1"}]
        # snapshots are plain JSON-serializable data
        json.dumps(snap)

    def test_racing_writers_lose_no_updates(self):
        reg = MetricsRegistry()
        c = reg.counter("c")
        h = reg.histogram("h")
        n_threads, per = 8, 2000
        snaps = []

        def writer(t):
            for i in range(per):
                c.inc(k="shared")
                h.observe(1e-3 * (i + 1), k="shared")

        def reader():
            for _ in range(50):
                snaps.append(reg.snapshot())

        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(n_threads)] + \
                  [threading.Thread(target=reader)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert c.value(k="shared") == n_threads * per
        s = h.summary(k="shared")
        assert s["count"] == n_threads * per
        assert s["sum"] == pytest.approx(n_threads * per * (per + 1) / 2
                                         * 1e-3)
        # every mid-race snapshot was internally sane
        for snap in snaps:
            for cell in snap.get("c", {}).get("cells", ()):
                assert 0 <= cell["value"] <= n_threads * per

    def test_racing_get_or_define_yields_one_instrument(self):
        reg = MetricsRegistry()
        seen = []

        def define():
            seen.append(reg.counter("same"))

        threads = [threading.Thread(target=define) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert all(inst is seen[0] for inst in seen)


# ---------------------------------------------------------------------------
# span tracer: no-op path, nesting, exports, validators
# ---------------------------------------------------------------------------

class TestSpans:
    def test_disabled_span_is_shared_noop(self):
        tr = SpanTracer()            # disabled is the default
        a = tr.span("x", k=1)
        b = tr.span("y")
        assert a is b                # one shared object: allocates nothing
        with a as sp:
            sp.annotate(more=2)      # annotate is a no-op, never raises
        assert tr.spans() == []

    def test_nesting_depth_and_args(self):
        tr = SpanTracer(enabled=True)
        with tr.span("outer", stage="a"):
            with tr.span("inner") as sp:
                sp.annotate(cache="hit")
            with tr.span("inner2"):
                pass
        spans = tr.spans()
        assert [(s["name"], s["depth"]) for s in spans] == \
            [("outer", 0), ("inner", 1), ("inner2", 1)]
        outer = spans[0]
        assert outer["args"] == {"stage": "a"}
        assert spans[1]["args"] == {"cache": "hit"}
        # children fall inside the parent interval
        for child in spans[1:]:
            assert child["ts_us"] >= outer["ts_us"]
            assert (child["ts_us"] + child["dur_us"]
                    <= outer["ts_us"] + outer["dur_us"] + 1e-6)

    def test_record_synthetic_spans(self):
        tr = SpanTracer(enabled=True)
        t0 = tr.now()
        tr.record("pass.order", t0, 0.25, points=3)
        (rec,) = tr.spans()
        assert rec["name"] == "pass.order"
        assert rec["dur_us"] == pytest.approx(0.25e6)
        assert rec["args"] == {"points": 3}

    def test_jsonl_roundtrip_and_schema(self, tmp_path):
        tr = SpanTracer(enabled=True)
        with tr.span("a", arch="hpc:cg"):
            with tr.span("b"):
                pass
        path = tmp_path / "spans.jsonl"
        assert tr.export_jsonl(path) == 2
        assert validate_jsonl(path) == 2
        loaded = load_jsonl(path)
        assert sorted(r["name"] for r in loaded) == ["a", "b"]
        for rec in loaded:
            assert tuple(sorted(rec)) == tuple(sorted(JSONL_KEYS))

    def test_chrome_export_and_schema(self, tmp_path):
        tr = SpanTracer(enabled=True)
        with tr.span("session.codesign", strategy="default"):
            with tr.span("codesign.search"):
                pass
        path = tmp_path / "trace.json"
        assert tr.export_chrome(path) == 2
        assert validate_chrome(path) == 2
        with open(path) as f:
            doc = json.load(f)
        assert doc["displayTimeUnit"] == "ms"
        by_name = {ev["name"]: ev for ev in doc["traceEvents"]}
        assert by_name["session.codesign"]["ph"] == "X"
        assert by_name["session.codesign"]["cat"] == "session"
        assert by_name["codesign.search"]["cat"] == "codesign"
        assert by_name["session.codesign"]["args"] == {"strategy": "default"}

    def test_validators_reject_schema_violations(self, tmp_path):
        bad = tmp_path / "bad.jsonl"
        bad.write_text('{"name": "x", "ts_us": 0}\n')
        with pytest.raises(ValueError, match="missing keys"):
            validate_jsonl(bad)
        extra = tmp_path / "extra.jsonl"
        extra.write_text(json.dumps(
            {k: ({} if k == "args" else "x" if k == "name" else 0)
             for k in JSONL_KEYS} | {"rogue": 1}) + "\n")
        with pytest.raises(ValueError, match="unexpected keys"):
            validate_jsonl(extra)
        badc = tmp_path / "bad.json"
        badc.write_text(json.dumps({"traceEvents": [
            {"name": "x", "ph": "B", "ts": 0, "dur": 0,
             "pid": 1, "tid": 1}]}))
        with pytest.raises(ValueError, match="ph must be 'X'"):
            validate_chrome(badc)

    def test_nonjson_args_are_reprd(self):
        tr = SpanTracer(enabled=True)
        with tr.span("x", shape=(4, 4)):
            pass
        (rec,) = tr.spans()
        assert rec["args"]["shape"] == repr((4, 4))

    def test_threads_record_independent_depths(self):
        tr = SpanTracer(enabled=True)

        def work(i):
            with tr.span(f"outer{i}"):
                with tr.span(f"inner{i}"):
                    pass

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        spans = tr.spans()
        assert len(spans) == 16
        depth = {s["name"]: s["depth"] for s in spans}
        for i in range(8):
            assert depth[f"outer{i}"] == 0 and depth[f"inner{i}"] == 1


# ---------------------------------------------------------------------------
# the repro.obs facade: env spec parsing, sinks, global instrumentation
# ---------------------------------------------------------------------------

class TestFacade:
    def test_configure_from_env_off_values(self):
        assert obs.configure_from_env("") is False
        assert obs.configure_from_env("0") is False
        assert obs.configure_from_env("off") is False

    def test_configure_from_env_malformed_part_warns(self, tmp_path):
        was_enabled = obs.tracer().enabled
        try:
            with pytest.warns(UserWarning, match="unrecognized part"):
                assert obs.configure_from_env("bogus-spec") is True
        finally:
            if not was_enabled:
                obs.disable()

    def test_enable_flush_jsonl_sink(self, tmp_path):
        path = tmp_path / "out.jsonl"
        was_enabled = obs.tracer().enabled
        obs.enable(jsonl=str(path))
        try:
            with obs.span("facade.test"):
                pass
            counts = obs.flush()
            assert counts[str(path)] >= 1
            assert validate_jsonl(path) >= 1
            assert any(r["name"] == "facade.test"
                       for r in load_jsonl(path))
        finally:
            obs._SINKS[:] = [s for s in obs._SINKS if s[1] != str(path)]
            if not was_enabled:
                obs.disable()

    def test_global_instruments_exist(self):
        # the port's instrumented layers define their metrics at import on
        # the port's registry: each name defined once, kinds stable
        import repro_torch.api.session  # noqa: F401  (defines them)
        import repro_torch.exec.cuda    # noqa: F401
        import repro_torch.launch.serve  # noqa: F401
        import repro_torch.testing.faults  # noqa: F401
        reg = obs.registry()
        names = reg.names()
        for needed in ("session.stage_s", "session.stage_runs",
                       "codesign.search_s", "codesign.points",
                       "codesign.pins", "codesign.overbook_frac",
                       "exec.compile_s", "exec.run_s", "exec.traces",
                       "exec.dispatches", "exec.donated_bytes",
                       "exec.units", "faults.injected",
                       "serve.decode.traces", "serve.decode.dispatches"):
            assert needed in names
        with pytest.raises(TypeError):
            reg.histogram("session.stage_runs")   # defined as a counter

    def test_the_port_keeps_its_own_registry_and_tracer(self):
        assert obs.registry() is not jx_obs.registry()
        assert obs.tracer() is not jx_obs.tracer()

    def test_env_spellings_of_the_profiler_mirror(self):
        """``torchprof`` and the JAX package's ``jaxprof`` are accepted
        without a warning and switch nothing: spans reach an active
        ``torch.profiler`` session whatever ``CELLO_OBS`` says."""
        was_enabled = obs.tracer().enabled
        try:
            for spec in ("torchprof", "jaxprof", "1,torch_profiler"):
                obs.disable()
                with warnings.catch_warnings():
                    warnings.simplefilter("error")
                    assert obs.configure_from_env(spec) is True
                assert obs.tracer().enabled
                assert not hasattr(obs.tracer(), "torch_profiler")
        finally:
            if not was_enabled:
                obs.disable()


# ---------------------------------------------------------------------------
# parity with repro.obs, and the profiler mirror
# ---------------------------------------------------------------------------

def _drive(reg, samples):
    """One fixed sequence of counter, gauge and histogram operations."""
    c = reg.counter("reqs", "requests", unit="1")
    g = reg.gauge("depth", "queue depth")
    h = reg.histogram("lat", "latency", unit="s")
    for i, x in enumerate(samples):
        c.inc(bucket=f"b{i % 3}", scope="s1")
        c.inc(0.5, bucket="all", scope="s2")
        g.set(i % 7, q="a")
        g.add(-0.25, q="a")
        h.observe(float(x), k=f"k{i % 2}", scope="s1")
    h.observe(0.0, k="k0", scope="s1")
    h.observe(-1.0, k="k1", scope="s1")
    return h


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_same_operations_give_equal_snapshots_and_quantiles(seed):
    samples = np.random.default_rng(seed).lognormal(-6.0, 1.5, size=2000)
    h_pt = _drive(MetricsRegistry(), samples)
    h_jx = _drive(jx_obs.MetricsRegistry(), samples)
    assert h_pt.registry.snapshot() == h_jx.registry.snapshot()
    assert h_pt.registry.snapshot("s1") == h_jx.registry.snapshot("s1")
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        for k in ("k0", "k1"):
            assert h_pt.quantile(q, k=k, scope="s1") == \
                h_jx.quantile(q, k=k, scope="s1")


def test_port_exports_pass_the_jax_validators(tmp_path):
    tr = SpanTracer(enabled=True)
    with tr.span("session.codesign", arch="hpc:cg"):
        with tr.span("exec.dispatch", backend="cuda"):
            pass
    tr.record("codesign.pass.order", tr.now(), 0.001, points=3)
    jsonl, chrome = tmp_path / "s.jsonl", tmp_path / "s.json"
    assert tr.export_jsonl(jsonl) == 3
    assert tr.export_chrome(chrome) == 3
    assert jx_obs.validate_jsonl(jsonl) == 3
    assert jx_obs.validate_chrome(chrome) == 3
    assert jx_obs.JSONL_KEYS == JSONL_KEYS


def test_a_span_shows_in_a_torch_profiler_trace():
    """Inside a ``torch.profiler`` session every span enters the
    profiler's range, recorded by the tracer or not; outside one the
    disabled tracer hands out its shared no-op span."""
    from torch.profiler import ProfilerActivity, profile
    on, off = SpanTracer(enabled=True), SpanTracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with on.span("exec.dispatch", backend="cuda"):
            torch.ones(8).sum()
        with off.span("exec.replay") as sp:
            sp.annotate(k=1)
            torch.ones(8).sum()
    names = [ev.name for ev in prof.events()]
    assert "exec.dispatch" in names and "exec.replay" in names
    assert [r["name"] for r in on.spans()] == ["exec.dispatch"]
    assert off.spans() == []
    assert off.span("a") is off.span("b") is tracing._NULL_SPAN


def test_a_runs_stages_show_in_a_torch_profiler_trace_with_the_tracer_off():
    """A ``cuda`` run on the CPU under ``torch.profiler``, the tracer
    disabled: its feed, replay (here the walk) and copy-out stages are
    ranges under ``exec.dispatch``, and nothing is recorded; with no
    profiler the disabled ``span()`` is the shared null span."""
    from torch.profiler import ProfilerActivity, profile
    import repro_torch.api as pt_api
    tr = obs.tracer()
    was_enabled = tr.enabled
    obs.disable()
    try:
        plan = (pt_api.Session(device="cpu", use_cache=False)
                .trace(workload="cg_sparse", n=64, iters=2,
                       pattern="laplacian5")
                .analyze().codesign().lower(backend="cuda"))
        plan.run(seed=0)
        recorded = len(tr.spans())
        assert obs.span("exec.feed") is tracing._NULL_SPAN
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            plan.run(seed=1)
        assert obs.span("exec.replay") is tracing._NULL_SPAN
        assert len(tr.spans()) == recorded
    finally:
        if was_enabled:
            obs.enable()
    events = prof.events()
    assert [ev.name for ev in events].count("exec.dispatch") == 1
    for stage in ("exec.feed", "exec.replay", "exec.copy_out"):
        (ev,) = [ev for ev in events if ev.name == stage]
        assert ev.cpu_parent is not None
        assert ev.cpu_parent.name == "exec.dispatch", stage


def test_session_and_executor_spans_on_the_cpu(tmp_path):
    """A traced port session: stage spans, the search's spans and the
    executor's compile and dispatch spans, exported and validated.  The
    session's disk cache is off, so that the search runs."""
    import repro_torch.api as pt_api
    tr = obs.tracer()
    was_enabled = tr.enabled
    tr.clear()
    obs.enable()
    try:
        plan = (pt_api.Session(device="cpu", use_cache=False)
                .trace(workload="cg", n=32, iters=2)
                .analyze().codesign().lower())
        plan.run(seed=0)
        plan.run(seed=1)
        names = [r["name"] for r in tr.spans()]
    finally:
        if not was_enabled:
            obs.disable()
    for stage in ("trace", "analyze", "codesign", "lower"):
        assert f"session.{stage}" in names
    assert "codesign.search" in names and "codesign.baselines" in names
    assert any(n.startswith("codesign.pass.") for n in names)
    assert names.count("exec.compile") == 1
    assert names.count("exec.dispatch") == 2
    path = tmp_path / "spans.jsonl"
    tr.export_jsonl(path)
    assert validate_jsonl(path) == len(tr.spans())
    tr.clear()


def test_cello_obs_sink_from_the_environment(tmp_path):
    """``CELLO_OBS=jsonl:PATH`` on a fresh interpreter: the port's spans
    are flushed at exit and pass the validator."""
    path = tmp_path / "env.jsonl"
    code = ("import repro_torch.api as a\n"
            "a.Session(device='cpu').trace(workload='cg', n=32, iters=2)"
            ".analyze().codesign().lower().run()\n")
    import os
    env = {**os.environ, "CELLO_OBS": f"jsonl:{path}",
           "PYTHONPATH": os.pathsep.join(p for p in sys.path if p)}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    names = {r["name"] for r in load_jsonl(path)}
    assert validate_jsonl(path) >= 6
    assert {"session.codesign", "exec.compile", "exec.dispatch"} <= names
