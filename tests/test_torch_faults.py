"""The port's fault-injection harness, ``repro_torch.testing.faults``:
the cases of ``tests/test_faults.py`` run against the port's copy (spec
grammar, site/qualifier matching, deterministic fire counts, corrupt
transforms, env configuration), then parity with ``repro.testing.faults``
(equal parses of the same specs) and the executor's sites,
``exec.compile@cuda`` and ``exec.dispatch@cuda``, firing in the port's
``run()``."""
import time

import pytest

import repro.testing.faults as jx_faults
from repro_torch.testing import faults
from repro_torch.testing.faults import InjectedFault


@pytest.fixture(autouse=True)
def _clean_rules():
    faults.clear()
    yield
    faults.clear()


class TestSpecParsing:
    def test_minimal_clause(self):
        (r,) = faults.parse_spec("exec.compile=fail")
        assert (r.site, r.kind, r.qualifier, r.times, r.skip) == \
            ("exec.compile", "fail", None, None, 0)

    def test_full_grammar(self):
        rules = faults.parse_spec(
            "exec.compile@pallas=fail:x3, serve.dispatch=slow:0.05:x2,"
            "codesign.cache=corrupt:x1:skip2")
        a, b, c = rules
        assert (a.site, a.qualifier, a.times) == \
            ("exec.compile", "pallas", 3)
        assert (b.kind, b.delay_s, b.times) == ("slow", 0.05, 2)
        assert (c.kind, c.times, c.skip) == ("corrupt", 1, 2)

    def test_empty_spec_is_no_rules(self):
        assert faults.parse_spec("") == []
        assert faults.parse_spec(" , ") == []

    @pytest.mark.parametrize("bad", [
        "exec.compile",               # no kind
        "=fail",                      # no site
        "site=explode",               # unknown kind
        "site=fail:banana",           # unparseable option
    ])
    def test_bad_clauses_raise(self, bad):
        with pytest.raises(ValueError):
            faults.parse_spec(bad)


class TestCheck:
    def test_inactive_is_noop(self):
        assert not faults.active()
        faults.check("exec.compile", backend="pallas")   # no raise

    def test_fail_exact_count(self):
        with faults.inject("exec.compile", times=2) as rule:
            for _ in range(2):
                with pytest.raises(InjectedFault):
                    faults.check("exec.compile")
            faults.check("exec.compile")         # 3rd call unharmed
            faults.check("exec.compile")
            assert rule.fired == 2 and rule.seen == 4
        assert not faults.active()               # context disarmed

    def test_qualifier_must_match_a_context_value(self):
        with faults.inject("exec.compile@pallas"):
            faults.check("exec.compile", backend="reference")   # no match
            with pytest.raises(InjectedFault):
                faults.check("exec.compile", backend="pallas")

    def test_skip_lets_first_calls_through(self):
        with faults.inject("site", times=1, skip=2) as rule:
            faults.check("site")
            faults.check("site")
            with pytest.raises(InjectedFault):
                faults.check("site")
            assert (rule.seen, rule.fired) == (3, 1)

    def test_slow_sleeps(self):
        with faults.inject("serve.dispatch", kind="slow", delay_s=0.05,
                           times=1):
            t0 = time.perf_counter()
            faults.check("serve.dispatch", backend="reference")
            assert time.perf_counter() - t0 >= 0.045
            t0 = time.perf_counter()
            faults.check("serve.dispatch", backend="reference")  # spent
            assert time.perf_counter() - t0 < 0.04

    def test_message_carries_site(self):
        with faults.inject("exec.dispatch"):
            with pytest.raises(InjectedFault, match="exec.dispatch"):
                faults.check("exec.dispatch", backend="pallas")

    def test_injected_counter_bumps(self):
        from repro_torch import obs
        c = obs.registry().counter("faults.injected")
        before = c.value(site="unit.test.site", kind="fail")
        with faults.inject("unit.test.site", times=1):
            with pytest.raises(InjectedFault):
                faults.check("unit.test.site")
        assert c.value(site="unit.test.site", kind="fail") == before + 1


class TestCorrupt:
    def test_corrupt_truncates_to_half(self):
        blob = "x" * 100
        with faults.inject("codesign.cache", kind="corrupt", times=1):
            assert faults.corrupt_text("codesign.cache", blob) == "x" * 50
            # count spent: passthrough afterwards
            assert faults.corrupt_text("codesign.cache", blob) == blob

    def test_corrupt_ignores_other_sites_and_kinds(self):
        blob = b"payload"
        with faults.inject("other.site", kind="corrupt"):
            assert faults.corrupt_bytes("codesign.cache", blob) == blob
        with faults.inject("codesign.cache", kind="fail"):
            # fail rules never mangle payloads (and corrupt_* never raises)
            assert faults.corrupt_bytes("codesign.cache", blob) == blob

    def test_check_ignores_corrupt_rules(self):
        with faults.inject("codesign.cache", kind="corrupt"):
            faults.check("codesign.cache")       # no raise, no sleep


class TestEnvConfig:
    def test_configure_from_env_arms_and_replaces(self):
        armed = faults.configure_from_env(
            {faults.ENV_VAR: "a.site=fail:x1,b.site=slow:0.01"})
        assert len(armed) == 2 and faults.active()
        # re-configure replaces env rules rather than stacking them
        armed2 = faults.configure_from_env({faults.ENV_VAR: "c.site=fail"})
        assert len(armed2) == 1
        assert [r.site for r in faults.rules()] == ["c.site"]

    def test_env_rules_coexist_with_injected(self):
        faults.configure_from_env({faults.ENV_VAR: "env.site=fail"})
        with faults.inject("ctx.site"):
            assert {r.site for r in faults.rules()} == \
                {"env.site", "ctx.site"}
            faults.configure_from_env({})        # drops env rules only
            assert [r.site for r in faults.rules()] == ["ctx.site"]

    def test_inject_spec_context(self):
        with faults.inject_spec("x.site=fail:x1"):
            with pytest.raises(InjectedFault):
                faults.check("x.site")
        assert not faults.active()


# ---------------------------------------------------------------------------
# parity with repro.testing.faults, and the executor's sites
# ---------------------------------------------------------------------------

SPECS = [
    "exec.compile=fail",
    "exec.compile@cuda=fail:x3, exec.dispatch=slow:0.05:x2,"
    "codesign.cache=corrupt:x1:skip2",
    "a.site@q=slow, b.site=fail:skip4:x1, c.site=slow:0.5",
    " , exec.dispatch@reference=fail:x0",
]


def _fields(rule):
    return (rule.site, rule.kind, rule.qualifier, rule.delay_s, rule.times,
            rule.skip, rule.message)


@pytest.mark.parametrize("spec", SPECS)
def test_specs_parse_alike_in_both_packages(spec):
    assert [_fields(r) for r in faults.parse_spec(spec)] == \
        [_fields(r) for r in jx_faults.parse_spec(spec)]


@pytest.mark.parametrize("bad", ["exec.compile", "=fail", "site=explode",
                                 "site=fail:banana"])
def test_bad_specs_raise_alike_in_both_packages(bad):
    with pytest.raises(ValueError):
        faults.parse_spec(bad)
    with pytest.raises(ValueError):
        jx_faults.parse_spec(bad)


def test_the_two_harnesses_arm_apart():
    with faults.inject("exec.compile"):
        assert faults.active() and not jx_faults.active()
        jx_faults.check("exec.compile")          # the JAX rules: none


def _cpu_plan(backend="cuda"):
    import repro_torch.api as pt_api
    return (pt_api.Session(device="cpu").trace(workload="cg", n=32, iters=2)
            .analyze().codesign().lower(backend=backend))


@pytest.mark.parametrize("backend", ["cuda", "reference", "cuda-perunit"])
def test_exec_compile_site_fires_in_run(backend):
    plan = _cpu_plan()
    with faults.inject(f"exec.compile@{backend}", times=1) as rule:
        with pytest.raises(InjectedFault, match="exec.compile"):
            plan.run(backend=backend)
        assert rule.fired == 1
        out = plan.run(backend=backend)          # the rule is spent
    assert all(bool(v.isfinite().all()) for v in out.values())


def test_exec_dispatch_site_fires_in_run_and_counts_nothing():
    plan = _cpu_plan()
    prog = plan.compiled()
    with faults.inject("exec.dispatch@cuda", times=1):
        with pytest.raises(InjectedFault, match="exec.dispatch"):
            plan.run()
    assert prog.stats["runs"] == prog.stats["dispatches"] == 0
    with faults.inject("exec.dispatch@reference"):   # another backend
        plan.run()
    assert prog.stats["runs"] == prog.stats["dispatches"] == 1


def test_slow_dispatch_delays_run():
    plan = _cpu_plan()
    plan.run()
    with faults.inject_spec("exec.dispatch@cuda=slow:0.05:x1"):
        t0 = time.perf_counter()
        plan.run()
        assert time.perf_counter() - t0 >= 0.045


def test_cello_faults_from_the_environment():
    """``CELLO_FAULTS`` arms the port's rules at import, in the JAX
    package's grammar."""
    import os
    import subprocess
    import sys
    code = ("import repro_torch.api as a\n"
            "from repro_torch.testing.faults import InjectedFault\n"
            "p = a.Session(device='cpu').trace(workload='cg', n=32, "
            "iters=2).analyze().codesign().lower()\n"
            "try:\n    p.run()\nexcept InjectedFault:\n    print('fired')\n"
            "p.run()\nprint('spent')\n")
    env = {**os.environ, "CELLO_FAULTS": "exec.compile@cuda=fail:x1",
           "PYTHONPATH": os.pathsep.join(p for p in sys.path if p)}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["fired", "spent"]
