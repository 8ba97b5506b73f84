"""Occupancy grid of the reference recipe's ray marching (counterpart of
v3d_tpu/nerf/occupancy.py; nerfacc ``OccupancyGrid`` in
mesh_recon/models/neus.py:100-160): a dense res^3 EMA of the estimated alpha
and its binary mask, updated every ``update_interval`` steps from the
(jittered, after ``warmup_steps``) cell centres; lookups are voxel gathers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass
class OccupancyGrid:
    radius: float = 1.0
    resolution: int = 128
    ema_decay: float = 0.95
    update_interval: int = 16
    occ_threshold: float = 0.001
    warmup_steps: int = 256
    device: str = "cuda"

    def __post_init__(self):
        r = self.resolution
        self.occs = torch.zeros((r,) * 3, device=self.device)
        self.binary = torch.ones((r,) * 3, dtype=torch.bool, device=self.device)

    def cell_centers(self, offsets) -> torch.Tensor:
        """World points of the cells (r^3, 3), i-major, at ``offsets`` (a
        (r^3, 3) tensor in [0, 1), or a number) inside each cell."""
        r = self.resolution
        ar = torch.arange(r, device=self.occs.device)
        idx = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"),
                          dim=-1).reshape(-1, 3).float()
        pts01 = (idx + offsets) / r
        return pts01 * 2 * self.radius - self.radius

    def update(self, step: int, occ_eval_fn: Callable,
               offsets: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> None:
        """nerfacc every_n_step: EMA of the sampled occupancy, binary = occs
        > min(threshold, mean(occs)).  The jitter after warm-up is
        ``offsets`` when given, else drawn from ``generator``."""
        if step % self.update_interval != 0:
            return
        r = self.resolution
        if step < self.warmup_steps:
            offsets = 0.5
        elif offsets is None:
            offsets = torch.rand((r ** 3, 3), generator=generator,
                                 device=self.occs.device)
        occ = occ_eval_fn(self.cell_centers(offsets)).reshape((r,) * 3)
        self.occs = torch.maximum(self.occs * self.ema_decay, occ)
        thresh = torch.clamp(self.occs.mean(), max=self.occ_threshold)
        self.binary = self.occs > thresh

    def lookup(self, points: torch.Tensor) -> torch.Tensor:
        return grid_lookup(self.binary, points, self.radius)


def grid_lookup(binary: torch.Tensor, points: torch.Tensor,
                radius: float) -> torch.Tensor:
    """Binary occupancy at world points (True = keep the sample); points
    outside the cube are False."""
    r = binary.shape[0]
    x01 = (points + radius) / (2 * radius)
    idx = (x01 * r).to(torch.int32).clamp(0, r - 1).long()
    inside = ((x01 >= 0) & (x01 <= 1)).all(-1)
    return binary[idx[..., 0], idx[..., 1], idx[..., 2]] & inside
