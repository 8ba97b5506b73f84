"""Batch 3DGS evaluation CLI (counterpart of v3d_tpu/apps/full_eval.py,
itself of recon/full_eval.py): for each orbit video, fit gaussians
(``recon_gs.train_from_video``), render every training view, and score the
renders against the video's frames by mean PSNR and SSIM; one
``results.json`` for all videos, keyed by the video's name.

    python -m v3d_tpu_torch.apps.full_eval --videos a.mp4 b.mp4 --output eval_out/
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Sequence

import numpy as np
import torch

from v3d_tpu_torch.apps.recon_gs import train_from_video
from v3d_tpu_torch.data.video_io import read_video
from v3d_tpu_torch.gs.losses import psnr, ssim


def score_views(renders, frames) -> Dict[str, float]:
    """Mean PSNR and SSIM of (T, H, W, 3) renders against frames in [0, 1],
    view by view (full_eval.py:30-36)."""
    ps, ss = [], []
    with torch.no_grad():
        for img, ref in zip(renders, frames):
            ref = torch.as_tensor(ref, dtype=torch.float32, device=img.device)
            ps.append(float(psnr(img, ref)))
            ss.append(float(ssim(img, ref)))
    return {"psnr": float(np.mean(ps)), "ssim": float(np.mean(ss))}


def run(videos: Sequence[str], output: str, iterations: int = 4000,
        device="cuda", **fit_kwargs) -> Dict[str, Dict[str, float]]:
    """Fit and score each video; writes ``output/<name>/`` (the fit's
    outputs) and ``output/results.json``.  ``fit_kwargs`` go to
    ``train_from_video``."""
    results = {}
    for vid in videos:
        name = os.path.splitext(os.path.basename(vid))[0]
        trainer = train_from_video(vid, os.path.join(output, name), iterations,
                                   device=device, **fit_kwargs)
        frames = read_video(vid).astype(np.float32) / 255.0
        with torch.no_grad():
            renders = [trainer.render_view(i).image for i in range(len(frames))]
        results[name] = score_views(renders, frames)
        print(name, results[name], flush=True)
        del trainer, renders
    os.makedirs(output, exist_ok=True)
    with open(os.path.join(output, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--videos", nargs="+", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--iterations", type=int, default=4000)
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu only when asked for)")
    args = p.parse_args(argv)
    run(args.videos, args.output, args.iterations, device=args.device)


if __name__ == "__main__":
    main()
