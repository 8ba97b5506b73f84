"""Image -> asset in one process (counterpart of v3d_tpu/apps/full_asset.py):
the 18-view 512^2 orbit generation, the 3DGS fit and, with ``--mesh``, the
NeuS fit and its mesh, with each stage's wall-clock (the number behind the
paper's ~3 minutes per asset on one GPU), each stage a span
(``utils/trace.py``: ``full_asset.run`` > ``full_asset.asset`` >
``full_asset.generate``, ``full_asset.gs_fit``, ``full_asset.neus_fit_mesh``).

    python -m v3d_tpu_torch.apps.full_asset --input img.png --output asset/
    python -m v3d_tpu_torch.apps.full_asset --input img.png --output assets/ \\
        --mesh --assets 2

Each generation is written as ``<asset dir>/000000.mp4`` (3 fps), as the
JAX pipeline's ``sample_one(save=True)`` writes it, and both fits read that
file, so they see the video's pixels: the 3DGS fit through
``recon_gs.train_from_video``, NeuS from ``read_video`` of it.  ``--assets N`` runs the pipeline N times on one engine:
asset 2 onward is the amortised per-asset cost.  Without ``--checkpoint``
the generation runs on seeded random weights (the real compute; the fits
then fit noise).  The report, with every stage's seconds, the kernels each
stage launched and the mesh's size (null when the isosurface is empty),
is ``OUTPUT/full_asset.json``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Union

import numpy as np
import torch

from v3d_tpu_torch.apps.generate import sample_one
from v3d_tpu_torch.apps.recon_gs import train_from_video
from v3d_tpu_torch.apps.recon_neus import reconstruct
from v3d_tpu_torch.data.video_io import read_video, write_video
from v3d_tpu_torch.ops import LAUNCHES
from v3d_tpu_torch.utils.trace import stage


def _launched(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
            if v - before.get(k, 0)}


def run(image: Union[str, np.ndarray], output: str,
        checkpoint: Optional[str] = None, gs_iters: int = 4000,
        neus_steps: int = 3000, mesh: bool = False, num_steps: int = 25,
        mc_resolution: int = 192, assets: int = 1, device="cuda",
        engine=None, resolution: int = 512, gs_kwargs: Optional[Dict] = None,
        neus_kwargs: Optional[Dict] = None) -> Dict:
    """``image``: a path or an (H, W, 3|4) uint8 array.  ``engine`` replaces
    the V3D-512 engine that the first generation builds; ``gs_kwargs`` /
    ``neus_kwargs`` go to ``train_from_video`` / ``reconstruct`` (small
    runs).  Returns the report that it writes to ``output/full_asset.json``."""
    if isinstance(image, str):
        from PIL import Image

        image = np.asarray(Image.open(image))
    os.makedirs(output, exist_ok=True)
    report = {"checkpoint": checkpoint,
              "weights": "checkpoint" if checkpoint else "seeded random",
              "device": (torch.cuda.get_device_name(torch.device(device))
                         if torch.device(device).type == "cuda" else "cpu"),
              "assets": []}
    with stage("full_asset.run", report, "total_s"):
        for i in range(assets):
            stages: Dict = {"launches": {}}
            with stage("full_asset.asset", stages, "asset_total_s", asset=i):
                a_out = output if assets == 1 else os.path.join(output, f"a{i}")
                os.makedirs(a_out, exist_ok=True)

                before = dict(LAUNCHES)
                with stage("full_asset.generate", stages, "generate_18view_512"):
                    frames, engine, _ = sample_one(
                        image, engine=engine, num_steps=num_steps, seed=23 + i,
                        device=device, resolution=resolution, checkpoint=checkpoint)
                stages["launches"]["generate"] = _launched(before)
                video_path = os.path.join(a_out, "000000.mp4")
                write_video(video_path, frames, fps=3)
                print(f"[full_asset] a{i} generate: {stages['generate_18view_512']:.1f} s "
                      f"-> {video_path}", flush=True)

                before = dict(LAUNCHES)
                with stage("full_asset.gs_fit", stages, f"gs_fit_{gs_iters}"):
                    train_from_video(video_path, os.path.join(a_out, "gs"),
                                     iterations=gs_iters, seed=i, device=device,
                                     **(gs_kwargs or {}))
                stages["launches"]["gs_fit"] = _launched(before)
                print(f"[full_asset] a{i} 3DGS fit: {stages[f'gs_fit_{gs_iters}']:.1f} s",
                      flush=True)

                if mesh:
                    before = dict(LAUNCHES)
                    with stage("full_asset.neus_fit_mesh", stages, "neus_fit_mesh"):
                        _, m, _ = reconstruct(read_video(video_path),
                                              os.path.join(a_out, "mesh"),
                                              max_steps=neus_steps,
                                              mc_resolution=mc_resolution, seed=i,
                                              device=device, **(neus_kwargs or {}))
                    stages["launches"]["neus"] = _launched(before)
                    stages["mesh"] = ({"vertices": len(m.vertices), "faces": len(m.faces)}
                                      if len(m.vertices) else None)
                    print(f"[full_asset] a{i} NeuS fit + mesh: "
                          f"{stages['neus_fit_mesh']:.1f} s, mesh {stages['mesh']}",
                          flush=True)
            report["assets"].append(stages)
    report["per_asset_amortized_s"] = report["assets"][-1]["asset_total_s"]
    report["reference_claim_s"] = 180.0
    with open(os.path.join(output, "full_asset.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--gs-iters", type=int, default=4000)
    p.add_argument("--neus-steps", type=int, default=3000)
    p.add_argument("--num-steps", type=int, default=25)
    p.add_argument("--mc-resolution", type=int, default=192)
    p.add_argument("--mesh", action="store_true",
                   help="also run the NeuS mesh stage")
    p.add_argument("--assets", type=int, default=1,
                   help="run the pipeline N times in one process; the last "
                        "asset's row is the amortised per-asset cost")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu only when asked for)")
    args = p.parse_args(argv)
    run(args.input, args.output, args.checkpoint, args.gs_iters,
        args.neus_steps, args.mesh, args.num_steps, args.mc_resolution,
        args.assets, device=args.device)


if __name__ == "__main__":
    main()
