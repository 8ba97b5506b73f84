"""The card: whether the run may start, what it is, and the modules a run
must not load."""

from __future__ import annotations

import subprocess
import sys
from typing import Dict, List

# top-level module names, compared whole: ``v3d_tpu_torch`` is not ``v3d_tpu``
FORBIDDEN = ("jax", "jaxlib", "flax", "v3d_tpu")


class NoCard(RuntimeError):
    pass


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < n:
        raise NoCard(f"{torch.cuda.device_count()} CUDA devices, the cell asks for {n}")


def forbidden_loaded(modules=None) -> List[str]:
    """The forbidden top-level modules in ``sys.modules``."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def card_lines() -> List[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return [f"card: {line.strip()}" for line in out.stdout.splitlines() if line.strip()]
    except (OSError, subprocess.SubprocessError) as exc:
        return [f"card: nvidia-smi unavailable ({exc})"]


def device_block(count: int, device="cuda") -> Dict:
    import torch

    if torch.device(device).type != "cuda":    # a rehearsal on the CPU
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(count)))}
