"""Checkpoint validation, first stage (counterpart of
v3d_tpu/apps/validate_ckpt.py:35-58, ``check_conversion``): split a V3D /
SVD checkpoint on its key prefixes, count keys and parameters per part,
load it strictly into the port's V3D-512 engine and check that the UNet's
parameter count equals the checkpoint's UNet subtree.

    python -m v3d_tpu_torch.apps.validate_ckpt --ckpt V3D_512.ckpt \
        [--lpips lpips_vgg.npz] [--dpt omnidata_dpt.ckpt]

``--lpips`` / ``--dpt`` (validate_ckpt.py:442-450): load the LPIPS .npz or
the DPT weights and make one call on the device.  The JAX CLI's other
stages (``--forward`` and ``--full-loop`` against the live reference,
``--all`` / ``--report``) read a reference checkout or run the JAX bench and
are not part of the port.
"""

from __future__ import annotations

import argparse
import math
from typing import Dict

import numpy as np
import torch

from v3d_tpu_torch.core.checkpoint import (
    engine_modules,
    load_torch_state_dict,
    load_v3d_params,
    split_svd_state_dict,
)


def _n_params(sd) -> int:
    return sum(int(v.numel()) for v in sd.values())


def check_conversion(ckpt_path: str, engine=None, device="cuda") -> Dict:
    """Counts of the file and of what the engine took, as a dict:
    ``keys``, ``parts`` {name: (keys, parameters)} and ``loaded``
    {module: parameters}.  Without ``engine`` the V3D-512 engine is built
    on ``device``.  Raises if a key does not load or the UNet counts differ."""
    sd = load_torch_state_dict(ckpt_path)
    parts = split_svd_state_dict(sd)
    print(f"checkpoint keys: {len(sd)}")
    report = {"keys": len(sd), "parts": {}, "loaded": {}}
    for name, sub in parts.items():
        n = _n_params(sub)
        report["parts"][name] = (len(sub), n)
        print(f"  {name:6s} {len(sub):5d} keys  {n / 1e6:9.1f} M params")
    if engine is None:
        from v3d_tpu_torch.engines.builder import build_v3d_engine

        engine = build_v3d_engine(device=device)
    loaded = load_v3d_params(ckpt_path, engine)
    mods = engine_modules(engine)
    for name in loaded:
        n = sum(int(p.numel()) for p in mods[name].parameters())
        report["loaded"][name] = n
        print(f"loaded {name:8s} -> {n / 1e6:9.1f} M params")
    n_unet = report["loaded"]["unet"]
    if n_unet != report["parts"]["unet"][1]:
        raise AssertionError((n_unet, report["parts"]["unet"][1]))
    print("UNet param count matches the checkpoint's UNet subtree")
    return report


def check_lpips(path: str, device="cuda") -> float:
    """The LPIPS .npz's distance of a black and a gray 64^2 image on
    ``device``; raises unless the file loads and the distance is finite and
    positive."""
    from v3d_tpu_torch.metrics.lpips import load_lpips

    fn = load_lpips(path, device=device)
    if fn is None:
        raise FileNotFoundError(f"no LPIPS weights at {path}")
    black = torch.zeros(1, 64, 64, 3, device=torch.device(device))
    with torch.no_grad():
        d = float(fn(black, black + 0.5))
    if not (math.isfinite(d) and d > 0):
        raise AssertionError(f"lpips(black, gray) = {d}")
    print(f"LPIPS weights ingested: lpips(black, gray) = {d:.4f}")
    return d


def check_dpt(path: str, device="cuda") -> np.ndarray:
    """The DPT normal predictor's normals of one gray 64^2 frame on
    ``device``; raises unless the file loads and the normals are finite."""
    from v3d_tpu_torch.nerf.normals import load_dpt_normal_predictor

    predict = load_dpt_normal_predictor(path, device=device)
    if predict is None:
        raise FileNotFoundError(f"no DPT weights at {path}")
    normals = predict(np.full((1, 64, 64, 3), 0.5, np.float32))
    if normals.shape != (1, 64, 64, 3) or not np.isfinite(normals).all():
        raise AssertionError(f"DPT normals {normals.shape}, finite "
                             f"{bool(np.isfinite(normals).all())}")
    print("DPT weights ingested")
    return normals


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ckpt", default=None, help="svd_xt.safetensors or V3D_512.ckpt")
    p.add_argument("--lpips", default=None, help="LPIPS VGG .npz to ingest")
    p.add_argument("--dpt", default=None, help="Omnidata DPT .ckpt / .npz to ingest")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu only when asked for)")
    args = p.parse_args(argv)
    if not (args.ckpt or args.lpips or args.dpt):
        p.error("need --ckpt, --lpips or --dpt")
    if args.ckpt:
        check_conversion(args.ckpt, device=args.device)
    if args.lpips:
        check_lpips(args.lpips, args.device)
    if args.dpt:
        check_dpt(args.dpt, args.device)
    print("validate_ckpt: done")


if __name__ == "__main__":
    main()
