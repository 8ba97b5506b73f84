"""The readings that the limits of ``limits/<cell>.json`` are set from, at
the cell's own size, in one process:

    python3 portbench/bench/control.py --workload v3d512.generate \
        --seeds 11,12,13 --control-seeds 11,12,13 --out readings.jsonl \
        [--faults "guidance altered" --fault-seeds 11,12,13]

For each seed: the program's set-up (with a training cell's checked
steps), one unit at the cell's own load and the entry's unit after the
window (a training cell's window step), then the compared numbers of
the program (the lower readings) and, for the control seeds, of the
control: the reference computed in float8 in the program's place (the
upper readings), and for the fault seeds, of the program with each named
fault of ``faults.FAULTS`` planted.  One JSON line a seed and side.  The benchmark's runs do
not run it.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

# the checkout's root in place of this script's folder
sys.path[0] = str(Path(__file__).resolve().parents[2])

import numpy as np  # noqa: E402

from portbench.bench import manifest  # noqa: E402
from portbench.bench.faults import FAULTS, planted  # noqa: E402
from portbench.bench.seeded import seed_for  # noqa: E402
from portbench.reference.numerics import Numerics  # noqa: E402


def program_run(cell, seed: int, device="cuda", units: int = 1):
    """The program's set-up, ``units`` units of the window and the entry's
    unit after it; its state freed, its check due."""
    import torch

    entry = cell.entry.Entry(cell, seed, device)
    if entry.unit == "step":
        entry.warmup()           # the checked steps are the set-up's
    for i in range(units):
        entry.run_unit(i)
    entry.after_window()
    entry.release()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return entry


def readings(cell, seed: int, control: bool, device="cuda", units: int = 1):
    """[(side, numbers)] of one seed: the program's, then the control's."""
    entry = program_run(cell, seed, device, units)
    out = []
    for side, num in (("program", None), ("control", Numerics("fp8")))[:2 if control else 1]:
        rng = np.random.default_rng(seed_for(seed, "check"))
        out.append((side, entry.check(rng, numerics=num)))
    return out


def fault_readings(cell, seed: int, names, device="cuda", units: int = 1):
    """[(side, numbers)] of the program with each named fault planted."""
    out = []
    for name in names:
        with planted(FAULTS[cell.name][name]):
            entry = program_run(cell, seed, device, units)
            out.append((f"fault: {name}", entry.check(np.random.default_rng(
                seed_for(seed, "check")))))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control-seeds", default="", help="comma-separated")
    p.add_argument("--faults", default="", help="comma-separated names of faults.FAULTS")
    p.add_argument("--fault-seeds", default="", help="comma-separated; the faults' seeds")
    p.add_argument("--units", type=int, default=1, help="units of the window before the check")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    cell = manifest.load_cell(args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    fault_seeds = {int(s) for s in args.fault_seeds.split(",") if s}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        for s in [int(s) for s in args.seeds.split(",")]:
            t0 = time.perf_counter()
            faults = [f for f in args.faults.split(",") if f] if s in fault_seeds else []
            for side, numbers in (readings(cell, s, s in controls, units=args.units)
                                  + fault_readings(cell, s, faults, units=args.units)):
                line = {"workload": cell.name, "seed": s, "side": side, **numbers,
                        "seconds": time.perf_counter() - t0}
                print(json.dumps(line), flush=True)
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
