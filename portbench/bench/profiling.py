"""The traced slice: ``torch.profiler`` over whole units of work (a request
or steps) after the timed window.  From its trace: the device busy time
(the union of kernel and copy intervals), the device time by kernel name,
the slice's wall time, the longest device operations and the longest idle
gaps of the device by the host's CUDA call then; the chrome trace is
written over the previous one.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch


@dataclasses.dataclass
class Profile:
    units: int                 # requests or steps profiled
    window_s: float            # wall time of the slice, host clock
    busy_s: float              # device busy time in it
    kernels: Dict[str, float]  # device seconds by kernel name
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]

    def kernel_s(self, keys) -> float:
        """Device seconds of the kernels whose lower-case name holds one of
        ``keys``."""
        return sum(s for name, s in self.kernels.items()
                   if any(k in name.lower() for k in keys))


def _merge(spans):
    spans.sort()
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def profile_units(fn: Callable[[], int], trace_path: Path, top: int = 10) -> Profile:
    """Profile ``fn`` (which runs whole units and returns how many)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # the device's activity and the host's CUDA runtime calls only: recording
    # every aten op as well slows the host, which then idles the device
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        units = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0   # the slice, not the trace's collection
    spans, kernels, host = [], {}, []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if getattr(e, "is_user_annotation", False):
            continue     # a span of the host's marking (Optimizer.step#...), no device work
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((start, end))
            kernels[e.name] = kernels.get(e.name, 0.0) + (end - start) / 1e6
        else:
            host.append((start, end, e.name))
    if not spans:
        raise RuntimeError("the profiler recorded no device time: the traced "
                           "slice cannot give busy_s")
    merged = _merge(spans)
    busy = sum(e - s for s, e in merged) / 1e6
    # the idle gaps between device work, named by the host's CUDA call in
    # flight at each gap's middle ("host idle": the host was in Python or
    # aten between calls)
    host.sort()
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = {}
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = (e0 + s1) / 2
        i = bisect.bisect_right(starts, mid)
        name = "host idle"
        best = None
        for j in range(i - 1, max(-1, i - 200), -1):
            hs, he, hn = host[j]
            if he >= mid and (best is None or hs >= best[0]):
                best = (hs, hn)
        if best:
            name = best[1]
        gaps[name] = gaps.get(name, 0.0) + (s1 - e0) / 1e6
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    ops = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    return Profile(units=units, window_s=wall, busy_s=busy, kernels=kernels,
                   device_ops=[[n[:160], s] for n, s in ops],
                   idle_gaps=[[n[:160], s] for n, s in
                              sorted(gaps.items(), key=lambda kv: -kv[1])[:top]])
