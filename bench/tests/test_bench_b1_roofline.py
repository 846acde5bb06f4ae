"""``b1_roofline.solve``'s reader on a hand-made record: B1's passes by
their names' prefixes, the program's byte count over the traced window."""
from __future__ import annotations

import pytest

from bench import counts
from bench.harness.cell import Record
from bench.harness.devtrace import Traced
from bench.harness.spec import Spec

MIX = {"kind": "solve"}


def _snap(value):
    return {"exec.stream_bytes": {"cells": [
        {"labels": {"backend": "cuda", "scope": "cuda-1"}, "value": value}]}}


def _record(device, before=1e9, after=1e9 + 6.7e8):
    traced = Traced(on_cuda=True)
    traced.device = device
    traced.window_s = 1.0
    return Record("poisson2d_cg.solve", {}, MIX, {}, None, traced,
                  [{}, {}], [_snap(before), _snap(after)])


def test_reads_the_counted_bytes_at_the_peak_over_b1_device_time():
    reader = Spec().reader("b1_roofline.solve")
    # 0.25 ms of B1 in all (two passes' main kernels, one finalize), and
    # kernels of other layers, which the reader leaves out
    rec = _record([("main_kernel_059e55dd", 0.0, 100.0),
                   ("csr_spmv_kernel", 100.0, 400.0),
                   ("main_kernel_6f2f429a", 400.0, 540.0),
                   ("finalize_kernel_6f2f429a", 540.0, 550.0),
                   ("Memcpy DtoD (Device -> Device)", 550.0, 600.0)])
    want = 6.7e8 / counts.PEAKS["hbm_bytes_per_s"] / 250e-6 * 100.0
    assert reader.read(rec) == pytest.approx(want, rel=1e-12)
    assert 0 < want <= 100


def test_reads_nothing_without_b1_activity_or_without_the_counter():
    reader = Spec().reader("b1_roofline.solve")
    assert reader.read(_record([("csr_spmv_kernel", 0.0, 300.0)])) is None
    # a program that has no counter (an older one): nothing to read
    rec = _record([("main_kernel_059e55dd", 0.0, 100.0)])
    rec._snaps[True] = [{}, {}]
    assert reader.read(rec) is None
    assert reader.read(_record([("main_kernel_059e55dd", 0.0, 100.0)],
                               after=1e9)) is None
