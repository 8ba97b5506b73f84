"""Offline metrics CLI (counterpart of v3d_tpu/apps/metrics_cli.py, itself of
recon/metrics.py): PSNR, SSIM and, where LPIPS weights are present
(``$V3D_TPU_LPIPS_WEIGHTS``), LPIPS between a directory of PNG renders and
the PNGs of the same names in a ground-truth directory; the means as JSON.

    python -m v3d_tpu_torch.apps.metrics_cli --renders out/ --gt gt/
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch


def _read(path: str, device) -> torch.Tensor:
    from PIL import Image

    rgb = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return torch.tensor(rgb, device=device)


def evaluate(renders_dir: str, gt_dir: str, device="cuda") -> dict:
    """Mean PSNR / SSIM / LPIPS over the PNGs of ``renders_dir`` against
    ``gt_dir``, computed on ``device`` (the card unless the caller passes
    another); "lpips" only with weights, "n_images" always."""
    from v3d_tpu_torch.gs.losses import psnr, ssim
    from v3d_tpu_torch.metrics.lpips import load_lpips

    dev = torch.device(device)
    lpips_fn = load_lpips(device=dev)
    names = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(renders_dir, "*.png")))
    scores = {"psnr": [], "ssim": [], "lpips": []}
    with torch.no_grad():
        for name in names:
            r = _read(os.path.join(renders_dir, name), dev)
            g = _read(os.path.join(gt_dir, name), dev)
            scores["psnr"].append(float(psnr(r, g)))
            scores["ssim"].append(float(ssim(r, g)))
            if lpips_fn is not None:
                scores["lpips"].append(float(lpips_fn(r[None], g[None])))
    out = {k: float(np.mean(v)) for k, v in scores.items() if v}
    out["n_images"] = len(names)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--renders", required=True)
    p.add_argument("--gt", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu only when asked for)")
    args = p.parse_args(argv)
    print(json.dumps(evaluate(args.renders, args.gt, args.device), indent=2))


if __name__ == "__main__":
    main()
