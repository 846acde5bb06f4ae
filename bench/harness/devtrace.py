"""The device trace of a traced window, from ``torch.profiler``.

``Traced`` runs a body under the profiler (CPU and CUDA activities) and
keeps, for the window, every device activity (kernels, copies, sets) as
``(name, start_us, end_us)`` and every host event likewise.  From them:
``busy_s``, the union of device intervals; the time by device operation;
and the longest idle gaps, each named by the innermost host event that
covers its middle (what the host was doing while the device waited).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

Interval = Tuple[str, float, float]


class Traced:
    def __init__(self, on_cuda: bool):
        self.on_cuda = on_cuda
        self.device: List[Interval] = []
        self.host: List[Interval] = []
        self.window_s = 0.0
        self._prof = None
        self._t0 = 0.0

    def __enter__(self) -> "Traced":
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.on_cuda:
            acts.append(ProfilerActivity.CUDA)
        try:        # the serving worker's thread, too, where torch can
            from torch._C._profiler import _ExperimentalConfig
            cfg = _ExperimentalConfig(profile_all_threads=True)
            self._prof = profile(activities=acts, experimental_config=cfg)
        except TypeError:
            self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        import torch
        if self.on_cuda:
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return
        for ev in self._prof.events():
            tr = ev.time_range
            item = (ev.name, float(tr.start), float(tr.end))
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                self.device.append(item)
            else:
                self.host.append(item)
        self.device.sort(key=lambda e: e[1])
        self._prof = None

    # -- readings --------------------------------------------------------
    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for _n, s, e in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> Optional[float]:
        if not self.device:
            return None
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def by_name(self, match) -> Tuple[int, float]:
        """Launches and device seconds of the activities whose name
        ``match`` accepts."""
        n, t = 0, 0.0
        for name, s, e in self.device:
            if match(name):
                n += 1
                t += (e - s) * 1e-6
        return n, t

    def top_ops(self, k: int = 10) -> List[list]:
        tot: Dict[str, float] = {}
        for name, s, e in self.device:
            tot[name] = tot.get(name, 0.0) + (e - s) * 1e-6
        ranked = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:120], sec] for name, sec in ranked]

    def idle_gaps(self, k: int = 10) -> List[list]:
        busy = self.busy_intervals()
        gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)
                if busy[i + 1][0] > busy[i][1]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:k]:
            mid = (s + e) / 2
            cover = [(he - hs, name) for name, hs, he in self.host
                     if hs <= mid <= he]
            what = min(cover)[1] if cover else "no host event"
            out.append([what[:120], (e - s) * 1e-6])
        return out
