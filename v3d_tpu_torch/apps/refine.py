"""Texture refinement CLI (counterpart of v3d_tpu/apps/refine.py, itself of
mesh_recon/refine.py do_refine): refines a mesh's vertex colours against the
orbit frames, then writes the refined mesh and its orbit re-render.

    python -m v3d_tpu_torch.apps.refine --mesh mesh.obj --video FRAMES \\
        --output refined/

``FRAMES`` is the ``.mp4`` that ``apps.generate`` writes, its folder of PNG
frames (sorted by name) or an ``.npy`` of (T, H, W, 3) frames.  Outputs:
``refined.obj``, ``refined.glb``, and the T re-rendered views as
``refined_spiral.mp4`` (mp4v, 3 fps, as the JAX CLI writes it) and
``refined_spiral.npy`` (uint8).
``--lambda-lpips`` adds LPIPS (``metrics/lpips.py``) with the weights of
``$V3D_TPU_LPIPS_WEIGHTS``; without the file the term is left out, as the
JAX CLI leaves it.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from v3d_tpu_torch.apps.recon_gs import read_frames
from v3d_tpu_torch.data.video_io import write_video
from v3d_tpu_torch.meshops.mesh import Mesh
from v3d_tpu_torch.meshops.refine import RefineConfig, TextureRefiner
from v3d_tpu_torch.metrics.lpips import load_lpips


def do_refine(mesh_path: str, video_path: str, output: str,
              iters: int = 2000, num_opt_views: int = 16,
              lambda_lpips: float = 0.0, lr: float = 1e-3,
              device="cuda") -> Mesh:
    mesh = Mesh.read_obj(mesh_path)
    frames = read_frames(video_path)
    frames = (frames.astype(np.float32) / 255.0 if frames.dtype == np.uint8
              else frames.astype(np.float32))
    lpips_fn = None
    if lambda_lpips > 0:
        lpips_fn = load_lpips(device=device)
        if lpips_fn is None:
            print("LPIPS weights not found ($V3D_TPU_LPIPS_WEIGHTS): refining "
                  "with the MSE loss alone", flush=True)
    cfg = RefineConfig(iters=iters, num_opt_views=num_opt_views,
                       lambda_lpips=lambda_lpips, lr=lr)
    refiner = TextureRefiner(mesh, frames, cfg, lpips_fn=lpips_fn, device=device)
    losses = refiner.run()
    print(f"refined {iters} iters, loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    os.makedirs(output, exist_ok=True)
    out = refiner.export()
    out.write_obj(os.path.join(output, "refined.obj"))
    out.write_glb(os.path.join(output, "refined.glb"))
    # orbit re-render (refine.py:221-246 render_spiral)
    with torch.no_grad():
        renders = torch.stack([refiner.render(refiner.logits, i)[0]
                               for i in range(len(frames))])
    spiral = (renders * 255).to(torch.uint8).cpu().numpy()
    np.save(os.path.join(output, "refined_spiral.npy"), spiral)
    write_video(os.path.join(output, "refined_spiral.mp4"), spiral, fps=3)
    print(f"saved refined mesh + spiral to {output}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mesh", required=True)
    p.add_argument("--video", required=True,
                   help="an .mp4, a folder of PNG frames, or an .npy of "
                        "(T, H, W, 3)")
    p.add_argument("--output", required=True)
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--num-opt-views", type=int, default=16)
    p.add_argument("--lambda-lpips", type=float, default=0.0,
                   help="LPIPS weight beside the MSE; needs $V3D_TPU_LPIPS_WEIGHTS")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu only when asked for)")
    args = p.parse_args(argv)
    do_refine(args.mesh, args.video, args.output, args.iters,
              args.num_opt_views, args.lambda_lpips, device=args.device)


if __name__ == "__main__":
    main()
