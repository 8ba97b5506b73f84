"""One run of one cell: set-up, the timed window, the traced slice, the
entry's unit after the window, the per-layer readers, the correctness
check, the result line.

The entry (``entries/<entry>.py``) holds what is particular to a public
entry point of the port; this module is the same for every cell.  The
window is a closed loop of one client: each unit (a request or a training
step) starts when the last has finished, while the elapsed time is under
``--seconds``; it closes with a synchronise when the last unit started
before then has finished.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from portbench.bench import device as dev_mod
from portbench.bench.manifest import PKG, Cell, metric_reader
from portbench.bench.profiling import Profile, profile_units
from portbench.bench.seeded import seed_for

OUT_DIR = PKG / "out"


@dataclasses.dataclass
class Record:
    """What a per-layer reader reads."""

    cell: str
    config: dict
    traffic: dict
    units: int                       # units timed in the window
    window_s: float
    stages: List[Dict[str, float]]   # each timed unit's stage seconds
    profile: Optional[Profile]       # the traced slice
    work: Dict                       # the work of one unit, from the reference
    launches: Dict[str, float]       # the port's kernel launches a unit, traced slice


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    import torch

    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0


def timed_window(entry, seconds: float, device):
    stages = []
    t0 = time.perf_counter()
    while True:
        stages.append(entry.run_unit(len(stages)))
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    return time.perf_counter() - t0, stages


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    missing = set(numbers) ^ set(limits)
    if missing:
        raise KeyError(f"compared numbers and limits differ: {sorted(missing)}")
    return {k: {"value": float(numbers[k]), "limit": float(limits[k])} for k in numbers}


def read_per_layer(cell: Cell, rec: Record, say=print, pkg: Path = PKG) -> Dict:
    """Each per-layer metric of the cell by its reader; a reader that finds
    nothing to read returns None and its metric is left out.  A reader's
    optional ``lines(rec)`` go to ``say``."""
    metrics = {}
    for m in cell.per_layer:
        reader = metric_reader(m["name"], pkg)
        value = reader.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        for line in getattr(reader, "lines", lambda r: [])(rec):
            say(line)
    return metrics


def run(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
        started: float = None, say=print) -> Dict:
    """One run; returns the result line's object (its ``checks`` last)."""
    import torch

    from v3d_tpu_torch.ops import LAUNCHES

    started = time.perf_counter() if started is None else started
    entry = cell.entry.Entry(cell, seed, device)
    entry.warmup()
    sync(device)
    setup_s = time.perf_counter() - started
    window_s, stages = timed_window(entry, seconds, device)
    peak = peak_bytes(device)
    e2e = dict(entry.end_to_end(window_s, stages), setup_s=setup_s, peak_gib=peak / 2**30)

    prof = None
    launches: Dict[str, float] = {}
    if trace:
        for line in dev_mod.card_lines():
            say(line)
        before = dict(LAUNCHES)
        prof = profile_units(entry.profiled, OUT_DIR / f"{cell.name}.trace.json")
        launches = {k: (v - before[k]) / prof.units for k, v in LAUNCHES.items()
                    if v != before[k]}
    device_info = dev_mod.device_block(cell.chips, device)
    entry.after_window()
    entry.release()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    result = {"correct": False, "attempted": len(stages), "failed": 0}
    if trace:
        work = entry.work()
        rec = Record(cell.name, cell.config, cell.traffic, len(stages), window_s, stages,
                     prof, work, launches)
        say(f"launches a unit: {launches}")
        device_info.update(busy_s=prof.busy_s, window_s=prof.window_s)
        result["metrics"] = read_per_layer(cell, rec, say)
    else:
        result["metrics"] = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["device"] = device_info
    if trace:
        result["breakdown"] = {"device_ops": prof.device_ops, "idle_gaps": prof.idle_gaps}

    rng = np.random.default_rng(seed_for(seed, "check"))
    checks = judge(entry.check(rng), cell.limits)
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result


def check_lines(checks: Dict[str, Dict]) -> List[str]:
    return [f"check {k}: {c['value']:.6g} (limit {c['limit']:.6g})"
            for k, c in checks.items()]


def fail(msg: str, code: int) -> None:
    print(msg, file=sys.stderr, flush=True)
    raise SystemExit(code)
