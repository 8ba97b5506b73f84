"""Texture refinement (counterpart of v3d_tpu/meshops/refine.py, itself of
mesh_recon/refine.py:135-288).

Optimises per-vertex colours, held as logits through a sigmoid
(refine.py:184-185), so that the mesh's renders match the orbit frames:
each render is the rasterizer's antialiased colour composited over white,
the loss is the MSE (plus ``lambda_lpips`` times ``lpips_fn`` when both are
given), the optimiser Adam (optax.adam: eps 1e-8), and each iteration
takes one of ``num_opt_views`` uniformly spaced frames, drawn by
``np.random.RandomState(seed).randint`` as the JAX package draws it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from v3d_tpu_torch.data.cameras import get_uniform_poses
from v3d_tpu_torch.meshops.mesh import Mesh
from v3d_tpu_torch.meshops.rasterize import (
    MeshRasterizer,
    perspective_from_fov,
    verts_to_clip,
)


@dataclasses.dataclass
class RefineConfig:
    iters: int = 500
    lr: float = 1e-3
    num_opt_views: int = 16
    fov_deg: float = 60.0
    radius: float = 2.0
    elevation: float = 0.0
    lambda_lpips: float = 0.0
    max_per_tile: int = 256
    tile_chunk: int = 16


class TextureRefiner:
    def __init__(self, mesh: Mesh, frames: np.ndarray,
                 config: RefineConfig = RefineConfig(),
                 lpips_fn: Optional[Callable] = None, device="cuda"):
        """frames: (T, H, W, 3) in [0, 1] (the orbit video).  ``lpips_fn(img,
        target)`` takes (1, H, W, 3) tensors."""
        dev = torch.device(device)
        self.mesh = mesh
        self.cfg = config
        self.frames = frames
        self.lpips_fn = lpips_fn
        T, H, W = frames.shape[:3]
        self.raster = MeshRasterizer(H, W, config.max_per_tile, config.tile_chunk)
        poses = get_uniform_poses(T, config.radius, config.elevation, opengl=True)
        proj = perspective_from_fov(config.fov_deg, W / H)
        self.mvps = torch.tensor(np.stack([proj @ np.linalg.inv(p) for p in poses]),
                                 dtype=torch.float32, device=dev)
        # optimise ``num_opt_views`` uniformly spaced frames (refine.py:193)
        self.opt_views = np.linspace(0, T - 1, config.num_opt_views).astype(np.int32)
        init = mesh.vertex_colors if mesh.vertex_colors is not None else (
            np.full((mesh.vertices.shape[0], 3), 0.5, np.float32))
        init = np.clip(init, 1e-3, 1 - 1e-3)
        self.logits = torch.tensor(np.log(init / (1 - init)), dtype=torch.float32,
                                   device=dev, requires_grad=True)
        self.verts = torch.tensor(mesh.vertices, dtype=torch.float32, device=dev)
        self.faces = torch.tensor(mesh.faces, dtype=torch.long, device=dev)
        self.opt = torch.optim.Adam([self.logits], lr=config.lr, eps=1e-8)
        self.targets = torch.tensor(frames[self.opt_views], dtype=torch.float32,
                                    device=dev)

    def render(self, logits: torch.Tensor, view_idx: int):
        """(image (H, W, 3) over white, alpha (H, W)) of view ``view_idx``."""
        clip = verts_to_clip(self.verts, self.mvps[view_idx])
        out = self.raster(clip, self.faces, torch.sigmoid(logits))
        # antialiased composite over white (dr.antialias on colour + alpha,
        # mesh_recon/refine.py:115-168)
        a = out.alpha[..., None]
        return out.attr * a + (1.0 - a), out.alpha

    def step(self, view_slot: int) -> torch.Tensor:
        """One Adam step on optimised view ``view_slot``; returns the loss."""
        self.opt.zero_grad(set_to_none=True)
        img, _ = self.render(self.logits, int(self.opt_views[view_slot]))
        target = self.targets[view_slot]
        loss = torch.mean((img - target) ** 2)
        if self.lpips_fn is not None and self.cfg.lambda_lpips > 0:
            loss = loss + self.cfg.lambda_lpips * self.lpips_fn(img[None], target[None])
        loss.backward()
        self.opt.step()
        return loss.detach()

    def run(self, iters: Optional[int] = None, seed: int = 0) -> List[float]:
        rs = np.random.RandomState(seed)
        losses = []
        for _ in range(iters or self.cfg.iters):
            slot = int(rs.randint(len(self.opt_views)))
            losses.append(float(self.step(slot)))
        return losses

    def export(self) -> Mesh:
        colors = torch.sigmoid(self.logits).detach().cpu().numpy()
        return Mesh(self.verts.cpu().numpy(), self.faces.int().cpu().numpy(),
                    vertex_colors=colors).auto_normal()
