"""The gaps that decide ``correct``."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# a leaf whose reference gradient norm is under this share of the median
# leaf's moves under Adam by round-off alone: it is left out of the leaf gaps
NOUGHT_GRAD = 1e-3


def rel_gap(a: torch.Tensor, ref: torch.Tensor) -> float:
    """||a - ref|| / ||ref - mean(ref)||: the relative RMS gap."""
    a, ref = a.float(), ref.float().to(a.device)
    return float((a - ref).norm() / (ref - ref.mean()).norm().clamp(min=1e-30))


def leaf_gap(got: Dict[str, float], want: Dict[str, float], grad: Dict[str, float]) -> float:
    """The worst leaf's |norm(got) - norm(want)| over the larger of the
    leaf's reference norm and the median leaf's, over the leaves whose
    reference gradient is not nought (``NOUGHT_GRAD``).  A leaf whose norm
    is under the limit times the median leaf's stays under the limit
    whatever it reads."""
    med_grad = float(np.median(list(grad.values())))
    keep = [k for k in want if grad[k] >= NOUGHT_GRAD * med_grad]
    med = float(np.median([want[k] for k in keep]))
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in keep)


def loss_gap(got, want) -> float:
    """The worst step's |loss - reference loss| / |reference loss|."""
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))
