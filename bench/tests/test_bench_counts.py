"""The yardstick reproduces the byte counts the benchmark quotes."""
from __future__ import annotations

import pytest

from bench import counts
from bench.harness.spec import Spec


@pytest.fixture(scope="module")
def cfgs():
    spec = Spec()
    return {c: spec.config(c) for c in ("poisson2d_cg", "hpcg27_bicgstab")}


def test_nonzeros(cfgs):
    assert counts.nnz(cfgs["poisson2d_cg"]) == 20_963_328
    # HPCG's 29,791,000 nonzeros, stored at 27 slots a row
    assert counts.nnz(cfgs["hpcg27_bicgstab"]) == 27 * 104 ** 3 == 30_371_328


def test_poisson_bytes(cfgs):
    cfg = cfgs["poisson2d_cg"]
    op = counts.operand_bytes(cfg)
    assert op == 268_337_156                     # 268.3 MB
    assert counts.vector_bytes(cfg) == 33_554_432
    per_iter = op + 6 * counts.vector_bytes(cfg)
    assert per_iter == 469_663_748               # 469.7 MB an iteration
    solve = counts.solve(cfg)
    assert solve["spmvs"] == 65
    assert solve["bytes"] == 65 * per_iter
    assert counts.least_seconds(solve, "float64") == pytest.approx(
        9.113e-3, rel=1e-3)
    assert counts.spmv(cfg)["bytes"] == op + 2 * 33_554_432


def test_bicgstab_bytes(cfgs):
    cfg = cfgs["hpcg27_bicgstab"]
    assert counts.operand_bytes(cfg) == 368_955_396           # 369.0 MB
    assert counts.vector_bytes(cfg) == 8_998_912
    solve = counts.solve(cfg)
    assert solve["spmvs"] == 33
    assert solve["bytes"] == 33 * 386_953_220 == 12_769_456_260  # 12.77 GB
    assert counts.least_seconds(solve, "float64") == pytest.approx(
        3.8118e-3, rel=1e-3)


def test_served_request_charges_a_share_of_the_operand(cfgs):
    cfg = cfgs["poisson2d_cg"]
    one = counts.solve(cfg, 1 / 16)
    assert one["bytes"] == pytest.approx(
        65 * (268_337_156 / 16 + 6 * 33_554_432))


def test_least_time_is_the_longer_bound(cfgs):
    cfg = cfgs["poisson2d_cg"]
    work = {"bytes": 0, "flops": 34e12}
    assert counts.least_seconds(work, "float64") == pytest.approx(1.0)
    assert counts.least_seconds(work, "float32") == pytest.approx(34 / 67)
    assert counts.least_seconds(counts.spmv(cfg), "float64") == \
        pytest.approx(counts.spmv(cfg)["bytes"] / 3.35e12)
