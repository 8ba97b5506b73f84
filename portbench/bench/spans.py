"""The port's spans (``v3d_tpu_torch/utils/trace.py``) on the traced slice's
device timeline.

The spans are taken while the profiler records the slice; the slice's
chrome trace (``out/<cell>.trace.json``, written by ``profiling.py``) is put
on their clock by its ``baseTimeNanoseconds`` (an event's ``ts`` is in us
after it; a span's times are ``time.time_ns()``).  Then:
- each kernel, copy and memset goes to the innermost span open when the
  host made its launch call (the runtime or driver event of the same
  ``correlation``), on whichever thread: autograd launches the backward on
  its own thread while the caller waits inside its span;
- each idle gap of the device (between the merged intervals of that work)
  goes to the innermost span open at the gap's midpoint, or to "outside
  any span" (``None``) when none is.
A span's device time and idle are its own and its descendants'.  The spans
are written to ``out/<cell>.spans.json`` on the trace's base, as a chrome
trace of their own.  The trace is parsed once a run (``for_record``).

Where the port has no spans (a checkout before them), or the slice's span
counts do not match the traffic's units and steps, the readers fall silent.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from portbench.bench.manifest import PKG

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "outside any span"


@dataclasses.dataclass
class Trace:
    base_ns: int
    device: List[Tuple[float, float, Optional[int]]]   # (start us, end us, correlation)
    launch_us: Dict[int, float]                        # correlation -> the launch call's start


@dataclasses.dataclass
class Attribution:
    spans: List[Dict]                     # start_us / end_us on the trace's base added
    device_s: Dict[Optional[int], float]  # device seconds launched under each span, own only
    idle_s: Dict[Optional[int], float]    # idle seconds whose midpoint lies in each span, own only
    first_last_us: Dict[Optional[int], Tuple[float, float]]   # own work's device interval
    busy_s: float
    dropped: int = 0

    def __post_init__(self):
        self.by_id = {s["id"]: s for s in self.spans}

    def _ancestors(self, s: Dict):
        p = s["parent"]
        while p is not None and p in self.by_id:
            yield p
            p = self.by_id[p]["parent"]

    def named(self, name: str, under: Optional[str] = None) -> List[Dict]:
        """The spans called ``name`` (with an ancestor called ``under``)."""
        return [s for s in self.spans if s["name"] == name and (
            under is None or any(self.by_id[a]["name"] == under for a in self._ancestors(s)))]

    def _subtree(self, spans: Sequence[Dict]) -> set:
        ids = {s["id"] for s in spans}
        return {s["id"] for s in self.spans
                if s["id"] in ids or any(a in ids for a in self._ancestors(s))}

    def device(self, spans: Sequence[Dict]) -> float:
        """Device seconds launched under ``spans`` and their descendants."""
        return sum(self.device_s.get(i, 0.0) for i in self._subtree(spans))

    def idle(self, spans: Sequence[Dict]) -> float:
        """Idle seconds whose midpoint lies in ``spans`` or their descendants."""
        return sum(self.idle_s.get(i, 0.0) for i in self._subtree(spans))

    def interval_s(self, spans: Sequence[Dict]) -> float:
        """First start to last end of the device work launched under
        ``spans`` and their descendants."""
        got = [self.first_last_us[i] for i in self._subtree(spans) if i in self.first_last_us]
        return (max(e for _, e in got) - min(s for s, _ in got)) / 1e6 if got else 0.0

    @property
    def idle_total_s(self) -> float:
        return sum(self.idle_s.values())

    def idle_by_name(self) -> List[Tuple[str, float, int]]:
        """(innermost span's name, idle seconds, gaps' spans) by idle."""
        out: Dict[str, List] = {}
        for i, v in self.idle_s.items():
            name = self.by_id[i]["name"] if i in self.by_id else OUTSIDE
            out.setdefault(name, [0.0, 0])
            out[name][0] += v
            out[name][1] += 1
        return sorted(((n, v, k) for n, (v, k) in out.items()), key=lambda x: -x[1])


def load_trace(path: Path) -> Trace:
    with open(path) as f:
        doc = json.load(f)
    device, launch = [], {}
    for e in doc.get("traceEvents", ()):
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launch[corr] = float(e["ts"])
    device.sort()
    return Trace(int(doc.get("baseTimeNanoseconds", 0)), device, launch)


def _innermost(spans: Sequence[Dict]) -> Tuple[List[float], List[Optional[int]]]:
    """Change points: from ``times[k]`` on, ``ids[k]`` is the innermost span
    open (the open one that opened last), None for none."""
    edges = sorted([(s["start_us"], 1, s["start_ns"], s["id"]) for s in spans]
                   + [(s["end_us"], 0, s["start_ns"], s["id"]) for s in spans])
    open_: Dict[int, Tuple[int, int]] = {}
    times, ids = [], []
    for t, opens, start_ns, sid in edges:
        if opens:
            open_[sid] = (start_ns, sid)
        else:
            open_.pop(sid, None)
        top = max(open_.values())[1] if open_ else None
        if times and times[-1] == t:
            ids[-1] = top
        else:
            times.append(t)
            ids.append(top)
    return times, ids


def _merge(intervals):
    merged: List[List[float]] = []
    for s, e, _ in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def attribute(trace: Trace, spans: Sequence[Dict], dropped: int = 0) -> Attribution:
    """Each device operation and each idle gap of ``trace`` to a span of
    ``spans`` (dicts with ``name``, ``start_ns``, ``end_ns``, ``id``,
    ``parent``)."""
    spans = [dict(s, start_us=(s["start_ns"] - trace.base_ns) / 1e3,
                  end_us=(s["end_ns"] - trace.base_ns) / 1e3) for s in spans]
    times, ids = _innermost(spans)

    def at(t: Optional[float]) -> Optional[int]:
        if t is None:
            return None
        k = bisect.bisect_right(times, t) - 1
        return ids[k] if k >= 0 else None

    device_s: Dict[Optional[int], float] = {}
    first_last: Dict[Optional[int], Tuple[float, float]] = {}
    for s, e, corr in trace.device:
        sid = at(trace.launch_us.get(corr))
        device_s[sid] = device_s.get(sid, 0.0) + (e - s) / 1e6
        f, l_ = first_last.get(sid, (s, e))
        first_last[sid] = (min(f, s), max(l_, e))
    merged = _merge(trace.device)
    idle_s: Dict[Optional[int], float] = {}
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        sid = at((e0 + s1) / 2)
        idle_s[sid] = idle_s.get(sid, 0.0) + (s1 - e0) / 1e6
    busy = sum(e - s for s, e in merged) / 1e6
    return Attribution(spans, device_s, idle_s, first_last, busy, dropped)


def write_spans(att: Attribution, base_ns: int, path: Path) -> None:
    """The spans as a chrome trace on ``base_ns``, each with its own device
    and idle ms."""
    events = [{"ph": "X", "cat": "span", "name": s["name"], "pid": "spans",
               "tid": s.get("thread") or 0, "ts": s["start_us"],
               "dur": s["end_us"] - s["start_us"],
               "args": dict(s.get("attrs") or {}, id=s["id"], parent=s["parent"],
                            root=s.get("root"),
                            device_ms=1e3 * att.device_s.get(s["id"], 0.0),
                            idle_ms=1e3 * att.idle_s.get(s["id"], 0.0))}
              for s in att.spans]
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"baseTimeNanoseconds": base_ns, "dropped": att.dropped,
                   "traceEvents": events}, f)


_LAST: Dict = {}


def for_record(rec, out_dir: Optional[Path] = None) -> Optional[Attribution]:
    """The traced slice of ``rec`` attributed to the port's spans, or None
    (no slice, no trace file, a port without spans, no span recorded).
    The first call of a run parses the trace, takes the port's spans and
    writes ``<cell>.spans.json``; the others get the same result."""
    if rec.profile is None:
        return None
    if _LAST.get("profile") is rec.profile:
        return _LAST["att"]
    try:
        from v3d_tpu_torch.utils import trace as port_trace
    except ImportError:
        return None
    out_dir = Path(out_dir) if out_dir is not None else PKG / "out"
    taken = [s.as_dict() for s in port_trace.take()]
    path = out_dir / f"{rec.cell}.trace.json"
    att = None
    if taken and path.is_file():
        tr = load_trace(path)
        att = attribute(tr, taken, port_trace.dropped())
        write_spans(att, tr.base_ns, out_dir / f"{rec.cell}.spans.json")
    _LAST.update(profile=rec.profile, att=att, said=False)
    return att


def sampling(rec) -> Optional[Dict[str, float]]:
    """A generation slice's sampler steps: ``unet_ms`` (device ms launched
    under a step's ``unet.forward``), ``glue_ms`` (under ``sampler.step``
    but outside it), ``idle_ms`` (idle with its midpoint in a step), each a
    step, and ``interval_ms`` (first to last device work launched under
    ``sampler.run``, a unit); None unless the slice holds one ``sampler.run``
    a unit and the traffic's steps, each with one ``unet.forward``."""
    att = for_record(rec)
    if att is None:
        return None
    units, steps = rec.profile.units, rec.traffic["params"].get("num_steps")
    runs, step_spans = att.named("sampler.run"), att.named("sampler.step")
    unets = att.named("unet.forward", under="sampler.step")
    if not steps or len(runs) != units or len(step_spans) != units * steps \
            or len(unets) != len(step_spans):
        return None
    n = len(step_spans)
    unet = att.device(unets)
    return {"unet_ms": 1e3 * unet / n,
            "glue_ms": 1e3 * (att.device(step_spans) - unet) / n,
            "idle_ms": 1e3 * att.idle(step_spans) / n,
            "steps": n,
            "interval_ms": 1e3 * sum(att.interval_s([r]) for r in runs) / units}


def training(rec) -> Optional[Dict[str, float]]:
    """A fine-tune slice's steps: device ms a step launched under
    ``trainer.forward``, ``trainer.backward``, ``trainer.update``, the idle
    ms a step whose midpoint lies outside forward and backward (``edge``),
    and the device busy ms a step; None unless each of those spans comes
    once a traced step."""
    att = for_record(rec)
    if att is None:
        return None
    units = rec.profile.units
    parts = {k: att.named(f"trainer.{k}") for k in ("step", "forward", "backward", "update")}
    if any(len(v) != units for v in parts.values()):
        return None
    inner = att.idle(parts["forward"]) + att.idle(parts["backward"])
    return {"forward_ms": 1e3 * att.device(parts["forward"]) / units,
            "backward_ms": 1e3 * att.device(parts["backward"]) / units,
            "update_ms": 1e3 * att.device(parts["update"]) / units,
            "edge_idle_ms": 1e3 * (att.idle_total_s - inner) / units,
            "busy_ms": 1e3 * att.busy_s / units}


def lines(rec, top: int = 8) -> List[str]:
    """The slice's idle by span (the innermost open at each gap's middle),
    and how far the spans account for the slice: said once a run."""
    att = for_record(rec)
    if att is None or _LAST.get("said"):
        return []
    _LAST["said"] = True
    total = att.idle_total_s
    out = [f"spans: {len(att.spans)} in the slice ({att.dropped} dropped); "
           f"device idle {1e3 * total:.3f} ms over {rec.profile.units} unit(s), "
           f"outside any span {1e3 * att.idle_s.get(None, 0.0):.3f} ms"]
    for name, s, k in att.idle_by_name()[:top]:
        out.append(f"  idle under {name}: {1e3 * s:.3f} ms "
                   f"({100 * s / total if total else 0:.1f}%, {k} span(s))")
    samp, train = sampling(rec), training(rec)
    if samp:
        acc = samp["unet_ms"] + samp["glue_ms"] + samp["idle_ms"]
        out.append(f"  sampling: (unet {samp['unet_ms']:.3f} + glue {samp['glue_ms']:.3f} + "
                   f"idle {samp['idle_ms']:.3f}) x {samp['steps'] // rec.profile.units} = "
                   f"{acc * samp['steps'] / rec.profile.units:.3f} ms a unit; sampler.run's "
                   f"device interval {samp['interval_ms']:.3f} ms")
    if train:
        parts = train["forward_ms"] + train["backward_ms"] + train["update_ms"]
        out.append(f"  step: forward {train['forward_ms']:.3f} + backward "
                   f"{train['backward_ms']:.3f} + update {train['update_ms']:.3f} = "
                   f"{parts:.3f} ms of {train['busy_ms']:.3f} busy "
                   f"({100 * parts / train['busy_ms']:.2f}%); edge idle "
                   f"{train['edge_idle_ms']:.3f} ms")
    return out
