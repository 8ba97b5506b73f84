"""Run one cell of the benchmark of ``v3d_tpu_torch`` once, from the root of
a checkout:

    python3 portbench/run.py --workload v3d512.generate --seed 7 --seconds 30 --trace 0

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix; ``bench/manifest.py`` finds their files by name.  The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` (each compared number beside its limit), which also close
standard error.  Without a CUDA card, or with fewer than the cell asks for,
it prints no result and exits 3.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def _process_age() -> float:
    """Seconds since this process started, so that set-up counts the
    interpreter's start and the imports."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


STARTED = time.perf_counter() - _process_age()
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.bench import device, manifest, session  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        import v3d_tpu_torch  # noqa: F401
    except ImportError as exc:
        session.fail(f"portbench: the port is not in this checkout ({exc})", 4)
    try:
        cell = manifest.load_cell(args.workload)
    except (KeyError, FileNotFoundError) as exc:
        session.fail(f"portbench: {exc}", 2)
    try:
        device.require_cards(cell.chips)
    except device.NoCard as exc:
        session.fail(f"portbench: no result: {exc}", 3)

    result = session.run(cell, args.seed, args.seconds, bool(args.trace),
                         started=STARTED, say=lambda s: print(s, flush=True))
    found = device.forbidden_loaded()
    if found:
        session.fail(f"portbench: no result: the run loaded {', '.join(found)}", 5)
    for line in session.check_lines(result["checks"]):
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
