"""The port's codesign disk cache (``repro_torch.api.cache``) and the
session surface around it (``Session(use_cache=, cache_dir=)``,
``CodesignConfig.use_cache``, ``CoDesigned.from_cache``), against the JAX
package's (``repro.api.cache``, ``tests/test_robustness.py::
TestCacheCorruption``, ``tests/test_api.py::TestCache``).

Every test has its own cache directory (``tmp_path``), as the JAX
package's tests do.  The two packages share nothing on disk: the port's
keys carry the package's name and its default directory is its own, so an
entry that one package wrote is never replayed by the other, even in one
directory.
"""
import json
import threading

import pytest
import torch

import repro.api as jx_api
import repro.api.cache as jx_cache
import repro_torch.api.cache as pt_cache
import repro_torch.api.session as pt_session
from repro_torch import obs
from repro_torch.api import CodesignConfig, ServeConfig, Session
from repro_torch.core.search import DefaultStrategy
from repro_torch.serve import PlanRouter, Server, request
from repro_torch.testing import faults

CG = dict(workload="cg", n=32, iters=2)


@pytest.fixture(autouse=True)
def _hermetic_cache_env(monkeypatch):
    """The tests behave the same whether or not the caller exported the
    kill-switch or a cache directory."""
    monkeypatch.delenv("CELLO_NO_CACHE", raising=False)
    monkeypatch.delenv("CELLO_CACHE_DIR", raising=False)
    faults.clear()
    yield
    faults.clear()


def _count(name):
    return obs.registry().counter(name).value()


def _measure(designed):
    m = designed.best.metrics
    return (designed.speedup(), designed.energy_ratio(),
            m.time_s, m.energy_j, m.hbm_bytes)


def _designed(tmp_path, **kw):
    return Session(device="cpu", cache_dir=tmp_path, **kw).trace(
        **CG).codesign()


# ---------------------------------------------------------------------------
# the twin of tests/test_robustness.py::TestCacheCorruption
# ---------------------------------------------------------------------------

class TestCacheCorruption:
    def test_truncated_entry_is_deleted_and_re_derived(self, tmp_path):
        first = _designed(tmp_path)
        assert not first.from_cache
        (entry,) = tmp_path.glob("*.json")
        entry.write_text(entry.read_text()[:40])      # truncate on disk
        before = _count("codesign.cache.corrupt")
        again = _designed(tmp_path)
        assert not again.from_cache                   # re-derived, no raise
        assert _count("codesign.cache.corrupt") == before + 1
        assert again.best.schedule.groups == first.best.schedule.groups
        # the re-derived result was re-published over the deleted entry
        third = _designed(tmp_path)
        assert third.from_cache

    def test_garbage_json_counts_corrupt_not_plain_miss(self, tmp_path):
        cache = pt_cache.CodesignCache(tmp_path)
        (tmp_path / "deadbeef.json").write_text("{not json at all")
        before = _count("codesign.cache.corrupt")
        misses = _count("codesign.cache.misses")
        assert cache.get("deadbeef") is None
        assert _count("codesign.cache.corrupt") == before + 1
        assert not (tmp_path / "deadbeef.json").exists()
        # a genuinely absent key is a plain miss: no corrupt bump
        assert cache.get("0000") is None
        assert _count("codesign.cache.corrupt") == before + 1
        assert _count("codesign.cache.misses") == misses + 2

    def test_injected_corruption_site(self, tmp_path):
        _designed(tmp_path)
        before = _count("codesign.cache.corrupt")
        with faults.inject("codesign.cache", kind="corrupt", times=1):
            res = _designed(tmp_path)
        assert not res.from_cache
        assert _count("codesign.cache.corrupt") == before + 1

    def test_stale_format_is_corrupt(self, tmp_path):
        _designed(tmp_path)
        (entry,) = tmp_path.glob("*.json")
        blob = json.loads(entry.read_text())
        blob["v"] = pt_cache._FORMAT_VERSION + 1
        entry.write_text(json.dumps(blob))
        before = _count("codesign.cache.corrupt")
        assert not _designed(tmp_path).from_cache
        assert _count("codesign.cache.corrupt") == before + 1


# ---------------------------------------------------------------------------
# a hit is the search, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trace", [
    dict(arch="gemma-7b", phase="decode", batch=8, kv_len=4096),
    dict(arch="granite-moe-1b-a400m", phase="prefill", batch=1, seq=1024),
    dict(arch=None, workload="cg_sparse", n=256, iters=4)],
    ids=["gemma-7b-decode", "granite-moe-prefill", "cg_sparse"])
def test_cache_hit_is_bit_identical(trace, tmp_path):
    trace = dict(trace)
    arch = trace.pop("arch")
    fresh = Session(arch, device="cpu", cache_dir=tmp_path).trace(
        **trace).analyze().codesign()
    cached = Session(arch, device="cpu", cache_dir=tmp_path).trace(
        **trace).codesign()
    assert not fresh.from_cache and cached.from_cache
    assert _measure(cached) == _measure(fresh)
    assert cached.best.schedule.pins == fresh.best.schedule.pins
    assert cached.best.schedule.groups == fresh.best.schedule.groups
    assert cached.best.schedule.order == fresh.best.schedule.order
    assert cached.best.report == fresh.best.report
    assert cached.split_sweep == fresh.split_sweep
    assert cached.baselines.keys() == fresh.baselines.keys()
    assert cached.lower().plan == fresh.lower().plan
    # and the JAX package's search of the same trace, field for field
    jx = jx_api.Session(arch, cache_dir=tmp_path / "jax").trace(
        **trace).codesign()
    assert _measure(cached) == _measure(jx)
    assert cached.best.schedule.groups == jx.best.schedule.groups


def test_a_hit_runs_bitwise_as_the_search(tmp_path):
    """The same plan gives the same program: a hit's run() on the CPU
    (the kernels' plain versions) is bitwise the searched plan's."""
    a = _designed(tmp_path).lower()
    b = _designed(tmp_path)
    assert b.from_cache
    b = b.lower()
    out_a, out_b = a.run(seed=3), b.run(seed=3)
    assert out_a.keys() == out_b.keys()
    for k in out_a:
        assert torch.equal(torch.as_tensor(out_a[k]),
                           torch.as_tensor(out_b[k])), k


def test_round_trip_of_a_result(tmp_path):
    res = _designed(tmp_path).result
    cache = pt_cache.CodesignCache(tmp_path / "rt")
    cache.put("k", res)
    back = cache.get("k")
    assert back.speedup() == res.speedup()
    assert back.split_sweep == res.split_sweep
    assert pt_cache.result_to_dict(back) == pt_cache.result_to_dict(res)
    assert not list((tmp_path / "rt").glob("*.tmp"))


# ---------------------------------------------------------------------------
# the key
# ---------------------------------------------------------------------------

def _recorded_keys(monkeypatch):
    fields = []
    key = pt_cache.CodesignCache.key

    def recording(**kw):
        fields.append(kw)
        return key(**kw)
    monkeypatch.setattr(pt_cache.CodesignCache, "key",
                        staticmethod(recording))
    return fields


def test_shards_enter_the_key_only_past_one(monkeypatch, tmp_path):
    fields = _recorded_keys(monkeypatch)
    sess = Session(device="cpu", cache_dir=tmp_path)
    designed = sess.trace(workload="cg", n=256, iters=4).codesign()
    designed.lower(mesh=1)                 # K=1: no second search
    assert len(fields) == 1 and "shards" not in fields[0]
    plan = designed.lower(mesh=4)
    assert len(fields) == 2 and fields[1]["shards"] == 4
    assert fields[1]["capacity"] == 4 * fields[0]["capacity"]
    assert not plan.codesigned.from_cache
    # the mesh plan's search is cached under its own key, and the
    # unsharded entry never stood in for it
    again = Session(device="cpu", cache_dir=tmp_path).trace(
        workload="cg", n=256, iters=4).codesign().lower(mesh=4)
    assert again.codesigned.from_cache
    assert again.codesigned.best.schedule.pins == \
        plan.codesigned.best.schedule.pins
    assert len(list(tmp_path.glob("*.json"))) == 2


def test_knobs_change_the_key(tmp_path):
    traced = Session(device="cpu", cache_dir=tmp_path).trace(**CG)
    traced.codesign()
    for cfg in (CodesignConfig(capacity_bytes=64 << 20),
                CodesignConfig(max_orders=4), CodesignConfig(splits=(0.5,)),
                CodesignConfig(strategy="greedy")):
        assert not traced.codesign(cfg).from_cache, cfg
        assert traced.codesign(cfg).from_cache, cfg


def test_a_strategy_without_a_stable_identity_is_not_cached(tmp_path):
    class Knob(DefaultStrategy):
        name = "knob"

    strategy = Knob()
    strategy.hook = lambda: None          # an address in its state's repr
    assert pt_cache.strategy_fingerprint(strategy) is None
    designed = Session(device="cpu", cache_dir=tmp_path).trace(
        **CG).codesign(CodesignConfig(strategy=strategy))
    assert not designed.from_cache
    assert not list(tmp_path.glob("*.json"))


# ---------------------------------------------------------------------------
# switches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value,on", [("1", False), ("yes", False),
                                      ("0", True), ("false", True),
                                      ("", True)])
def test_cello_no_cache(value, on, monkeypatch, tmp_path):
    monkeypatch.setenv("CELLO_NO_CACHE", value)
    assert pt_cache.cache_disabled_by_env() == (not on)
    assert jx_cache.cache_disabled_by_env() == (not on)
    _designed(tmp_path)
    assert _designed(tmp_path).from_cache == on
    assert bool(list(tmp_path.glob("*.json"))) == on
    # the kill-switch beats a per-call request
    sess = Session(device="cpu", cache_dir=tmp_path / "c")
    sess.trace(**CG).codesign(CodesignConfig(use_cache=True))
    assert bool(list((tmp_path / "c").glob("*.json"))) == on
    assert ("cache=on" in repr(sess)) == on


def test_use_cache_per_session_and_per_call(tmp_path):
    off = Session(device="cpu", cache_dir=tmp_path, use_cache=False)
    off.trace(**CG).codesign()
    assert not list(tmp_path.glob("*.json"))
    assert "cache=off" in repr(off)
    # the call's config overrides the session's default either way
    off.trace(**CG).codesign(CodesignConfig(use_cache=True))
    assert len(list(tmp_path.glob("*.json"))) == 1
    assert off.trace(**CG).codesign(
        CodesignConfig(use_cache=True)).from_cache
    on = Session(device="cpu", cache_dir=tmp_path)
    assert not on.trace(**CG).codesign(
        CodesignConfig(use_cache=False)).from_cache
    assert on.trace(**CG).codesign().from_cache
    assert CodesignConfig().use_cache is None
    assert jx_api.CodesignConfig().use_cache is None


def test_explain_and_reprs_show_the_cache(tmp_path):
    sess = Session(device="cpu", cache_dir=tmp_path)
    assert repr(sess).endswith("cache=on)")
    jx_repr = repr(jx_api.Session(cache_dir=tmp_path))
    assert jx_repr.endswith("cache=on)")
    fresh = sess.trace(**CG).codesign()
    hit = Session(device="cpu", cache_dir=tmp_path).trace(**CG).codesign()
    assert "cached" not in repr(fresh) and repr(hit).endswith(", cached)")
    assert "[cache hit]" not in fresh.lower().explain()
    assert "search strategy   : default [cache hit]" in \
        hit.lower().explain()
    assert hit.lower().report()["from_cache"] is True
    assert fresh.lower().report()["from_cache"] is False


def test_from_graph_takes_the_cache_knobs(tmp_path):
    from repro_torch.frontends.hpc import build_workload
    program = build_workload("cg", n=32, iters=2)
    traced = Session.from_graph(program, device="cpu", cache_dir=tmp_path)
    assert not traced.codesign().from_cache
    assert Session.from_graph(program, device="cpu",
                              cache_dir=tmp_path).codesign().from_cache
    off = Session.from_graph(program, device="cpu", cache_dir=tmp_path,
                             use_cache=False)
    assert not off.codesign().from_cache


# ---------------------------------------------------------------------------
# the two packages never replay each other's entries
# ---------------------------------------------------------------------------

def test_default_directories_are_apart(monkeypatch, tmp_path):
    assert pt_cache.default_cache_dir() != jx_cache.default_cache_dir()
    assert pt_cache.default_cache_dir().name == "codesign-torch"
    monkeypatch.setenv("CELLO_CACHE_DIR", str(tmp_path))
    assert pt_cache.default_cache_dir() == jx_cache.default_cache_dir() \
        == tmp_path
    assert Session(device="cpu").cache.root == tmp_path


@pytest.mark.parametrize("via_env", [False, True], ids=["cache_dir",
                                                         "CELLO_CACHE_DIR"])
def test_packages_never_replay_each_others_entries(via_env, monkeypatch,
                                                   tmp_path):
    if via_env:
        monkeypatch.setenv("CELLO_CACHE_DIR", str(tmp_path))
        kw = {}
    else:
        kw = dict(cache_dir=tmp_path)
    jx_first = jx_api.Session(**kw).trace(**CG).codesign()
    assert not jx_first.from_cache
    assert len(list(tmp_path.glob("*.json"))) == 1
    pt_first = Session(device="cpu", **kw).trace(**CG).codesign()
    assert not pt_first.from_cache               # the JAX entry is not one
    assert len(list(tmp_path.glob("*.json"))) == 2
    assert jx_api.Session(**kw).trace(**CG).codesign().from_cache
    assert Session(device="cpu", **kw).trace(**CG).codesign().from_cache
    # the other way round: a fresh directory, the port first
    other = tmp_path / "other"
    if via_env:
        monkeypatch.setenv("CELLO_CACHE_DIR", str(other))
    else:
        kw = dict(cache_dir=other)
    assert not Session(device="cpu", **kw).trace(**CG).codesign().from_cache
    assert not jx_api.Session(**kw).trace(**CG).codesign().from_cache
    assert len(list(other.glob("*.json"))) == 2


def test_same_fields_make_different_keys():
    fields = dict(arch="hpc:cg", phase="hpc", capacity=1 << 27)
    assert pt_cache.CodesignCache.key(**fields) != \
        jx_cache.CodesignCache.key(**fields)
    assert pt_cache.PACKAGE == "repro_torch"


# ---------------------------------------------------------------------------
# concurrency
# ---------------------------------------------------------------------------

def test_racing_writers_publish_whole_entries(tmp_path):
    res = _designed(tmp_path / "src").result
    cache = pt_cache.CodesignCache(tmp_path / "race")
    errors = []

    def writer():
        try:
            for _ in range(20):
                cache.put("k", res)
                got = cache.get("k")
                assert got is not None and got.speedup() == res.speedup()
        except AssertionError as e:
            errors.append(e)
    threads = [threading.Thread(target=writer) for _ in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert [p.name for p in (tmp_path / "race").iterdir()] == ["k.json"]


def test_router_builds_one_plan_for_concurrent_first_requests(tmp_path,
                                                              monkeypatch):
    """The router keeps no codesign memo of its own: concurrent first
    requests for one bucket get one plan (the router's lock, the
    session's trace memo), and a second bucket of the same workload
    replays the first one's search from the disk cache."""
    searches = []
    run_codesign = pt_session.run_codesign
    monkeypatch.setattr(pt_session, "run_codesign", lambda *a, **k:
                        searches.append(1) or run_codesign(*a, **k))
    router = PlanRouter(Session(device="cpu", cache_dir=tmp_path))
    assert not hasattr(router, "_designed")
    key = request("cg", n=32, iters=2).bucket()
    entries, barrier = [], threading.Barrier(8)

    def first_request():
        barrier.wait(timeout=30)
        entries.append(router.plan_for(key))
    threads = [threading.Thread(target=first_request) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(entries) == 8 and all(e is entries[0] for e in entries)
    assert len(searches) == 1
    st = router.stats()["buckets"][key.label]
    assert st == {"cache_hits": 7, "cache_misses": 1}
    # another bucket of the same workload: a plan of its own, no search
    other = request("cg", n=32, iters=2, dtype="float64",
                    backend="reference").bucket()
    entry = router.plan_for(other)
    assert entry is not entries[0]
    assert entry.bplan.plan.codesigned.from_cache
    assert len(searches) == 1


def test_server_answers_with_a_cold_and_a_warm_cache(tmp_path):
    """Two servers on one cache directory answer alike; the second
    searches nothing."""
    outs = []
    for _ in range(2):
        srv = Server(PlanRouter(Session(device="cpu", cache_dir=tmp_path)),
                     ServeConfig(max_batch_size=4, max_wait_us=1000))
        try:
            futs = [srv.submit(request("cg", n=32, iters=2, seed=s))
                    for s in range(4)]
            outs.append([f.result(timeout=120) for f in futs])
        finally:
            srv.close()
    assert len(list(tmp_path.glob("*.json"))) == 1
    for a, b in zip(*outs):
        assert a.outputs.keys() == b.outputs.keys()
        for k in a.outputs:
            assert torch.equal(a.outputs[k], b.outputs[k]), k


def test_counters_are_the_references():
    names = ("codesign.cache.hits", "codesign.cache.misses",
             "codesign.cache.corrupt", "codesign.cache.read_bytes",
             "codesign.cache.write_bytes")
    from repro import obs as jx_obs
    for name in names:
        pt = obs.registry().counter(name)
        jx = jx_obs.registry().counter(name)
        assert pt.help == jx.help, name
        assert pt.unit == jx.unit, name
