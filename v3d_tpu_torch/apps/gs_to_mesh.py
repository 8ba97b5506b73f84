"""3DGS -> mesh distillation (counterpart of v3d_tpu/apps/gs_to_mesh.py, itself
of recon/convert_nerf_mesh.py: fit_nerf :208 -> marching cubes ->
fit_mesh / fit_mesh_uv :300/:424 -> glb).

Renders the gaussians of a PLY on a dense orbit (through ``gs.render``: on
the card each view launches K4), distils them into a density NeRF
(``nerf.nerf_model.NerfField``), extracts the isosurface of ``5 - density``
(marching tetrahedra) and refines per-vertex colours against the renders.

    python -m v3d_tpu_torch.apps.gs_to_mesh --ply scene/point_cloud.ply --output mesh/

Outputs ``mesh/mesh.glb`` and ``mesh/mesh.obj``; an empty isosurface writes
no mesh.  Each fit step draws its rays' views, pixels and sample jitter
(``DistillDraws``) from a ``torch.Generator`` seeded with ``seed + 1``; a
caller may hand in other draws (the tests hand in the JAX keys').
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Iterable, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from v3d_tpu_torch.data.cameras import (
    Camera,
    fov2focal,
    get_ray_directions,
    get_uniform_poses,
)
from v3d_tpu_torch.gs.gaussians import FLOAT_FIELDS, Gaussians
from v3d_tpu_torch.gs.ply import load_ply
from v3d_tpu_torch.gs.render import render
from v3d_tpu_torch.meshops.mcubes import isosurface
from v3d_tpu_torch.meshops.mesh import Mesh
from v3d_tpu_torch.meshops.refine import RefineConfig, TextureRefiner
from v3d_tpu_torch.nerf.nerf_model import NerfField, NerfRenderer
from v3d_tpu_torch.utils.trace import stage


class DistillDraws(NamedTuple):
    """One fit step's random draws (gs_to_mesh.py:71-79)."""

    idx: torch.Tensor      # (R,) int64 view index
    xy: torch.Tensor       # (R, 2) int64 pixel column, row
    jitter: torch.Tensor   # (R, S) in [0, 1): sample placement


def generator_draws(gen: torch.Generator, n_views: int, resolution: int,
                    rays: int, samples: int) -> Iterator[DistillDraws]:
    """Draws for every step from ``gen`` on its device."""
    dev = gen.device
    while True:
        yield DistillDraws(
            torch.randint(0, n_views, (rays,), generator=gen, device=dev),
            torch.randint(0, resolution, (rays, 2), generator=gen, device=dev),
            torch.rand(rays, samples, generator=gen, device=dev))


def load_gaussians(ply_path: str, device) -> Gaussians:
    g = load_ply(ply_path)
    dev = torch.device(device)
    return Gaussians(alive=torch.tensor(g["alive"], device=dev),
                     **{k: torch.tensor(g[k], dtype=torch.float32, device=dev)
                        for k in FLOAT_FIELDS})


def sh_degree(g: Gaussians) -> int:
    return int(np.sqrt(1 + g.f_rest.shape[1])) - 1


def distill(ply_path: str, output: str, n_views: int = 36,
            fit_steps: int = 1500, rays_per_step: int = 4096,
            resolution: int = 256, mc_resolution: int = 192,
            radius: float = 1.0, cam_radius: float = 2.0,
            refine_iters: int = 500, seed: int = 0, device="cuda",
            draws: Optional[Iterable[DistillDraws]] = None
            ) -> Tuple[Mesh, Dict[str, float]]:
    """The distillation; returns (mesh, seconds per stage).  Each stage is
    a span (``utils/trace.py``) under ``gs_to_mesh.distill`` that ends on
    the device."""
    dev = torch.device(device)
    timings: Dict[str, float] = {}
    with stage("gs_to_mesh.distill", timings, "total_s"):
        # 1. render a dense orbit of supervision views (fit_nerf data)
        with stage("gs_to_mesh.render", timings, "render_s", dev):
            g = load_gaussians(ply_path, dev)
            bg = torch.ones(3, device=dev)
            with torch.no_grad():
                images = torch.stack([
                    render(g, Camera.from_c2w(p, 60.0, resolution, resolution), bg,
                           active_sh_degree=sh_degree(g)).image
                    for p in get_uniform_poses(n_views, cam_radius, 0.0)]).clamp(0, 1)

        # 2. fit the density NeRF on random rays
        with stage("gs_to_mesh.fit", timings, "fit_s", dev):
            poses = torch.tensor(get_uniform_poses(n_views, cam_radius, 0.0, opengl=True),
                                 device=dev)
            focal = fov2focal(np.deg2rad(60.0), resolution)
            dirs = torch.tensor(get_ray_directions(resolution, resolution, focal), device=dev)
            field = NerfField(radius=radius).to(dev)
            field.init_(torch.Generator(device=dev).manual_seed(seed))
            renderer = NerfRenderer(radius=radius, num_samples=192)
            opt = torch.optim.Adam(field.parameters(), lr=5e-3, eps=1e-8)
            if draws is None:
                draws = generator_draws(torch.Generator(device=dev).manual_seed(seed + 1),
                                        n_views, resolution, rays_per_step,
                                        renderer.num_samples)
            for i, d in zip(range(fit_steps), draws):
                idx, x, y = d.idx.to(dev), d.xy[:, 0].to(dev), d.xy[:, 1].to(dev)
                c2w = poses[idx]
                rd = torch.einsum("nij,nj->ni", c2w[:, :3, :3], dirs[y, x])
                rd = rd / (torch.linalg.norm(rd, dim=-1, keepdim=True) + 1e-12)
                out = renderer(c2w[:, :3, 3], rd, field, background_color=bg,
                               jitter=d.jitter.to(dev))
                loss = torch.mean((out.comp_rgb - images[idx, y, x]) ** 2)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                if (i + 1) % 300 == 0:
                    print(f"distill step {i + 1} loss {float(loss):.5f}", flush=True)

        # 3. isosurface on density (threshold at sigma*step ~ alpha 0.5)
        with stage("gs_to_mesh.isosurface", timings, "isosurface_s", dev):
            @torch.no_grad()
            def density_fn(pts):
                out = [field.density_feature(torch.tensor(pts[s:s + 262144], device=dev))[0]
                       for s in range(0, len(pts), 262144)]
                # level set: inside = high density -> negative "sdf"
                return 5.0 - torch.cat(out).cpu().numpy()

            verts, faces = isosurface(density_fn, radius=radius, resolution=mc_resolution)
            mesh = Mesh(verts, faces)
            print(f"extracted mesh: {len(verts)} verts, {len(faces)} faces", flush=True)
        if len(verts) == 0:
            print("WARNING: the isosurface is empty (no density above 5); no mesh "
                  "written", flush=True)
            return mesh, timings
        mesh.auto_normal()

        # 4. bake colours by refining against the rendered orbit
        with stage("gs_to_mesh.refine", timings, "refine_s", dev):
            if refine_iters > 0:
                refiner = TextureRefiner(
                    mesh, images.cpu().numpy(),
                    RefineConfig(iters=refine_iters, lr=0.05, num_opt_views=min(16, n_views),
                                 radius=cam_radius), device=dev)
                refiner.run()
                mesh = refiner.export()

        with stage("gs_to_mesh.write", timings, "write_s", dev):
            os.makedirs(output, exist_ok=True)
            mesh.write_glb(os.path.join(output, "mesh.glb"))
            mesh.write_obj(os.path.join(output, "mesh.obj"))
    print(f"saved {output}/mesh.glb", flush=True)
    return mesh, timings


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ply", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--fit-steps", type=int, default=1500)
    p.add_argument("--mc-resolution", type=int, default=192)
    p.add_argument("--refine-iters", type=int, default=500)
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu only when asked for)")
    args = p.parse_args(argv)
    distill(args.ply, args.output, fit_steps=args.fit_steps,
            mc_resolution=args.mc_resolution, refine_iters=args.refine_iters,
            device=args.device)


if __name__ == "__main__":
    main()
