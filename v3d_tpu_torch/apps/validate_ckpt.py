"""Checkpoint validation, first stage (counterpart of
v3d_tpu/apps/validate_ckpt.py:35-58, ``check_conversion``): split a V3D /
SVD checkpoint on its key prefixes, count keys and parameters per part,
load it strictly into the port's V3D-512 engine and check that the UNet's
parameter count equals the checkpoint's UNet subtree.

    python -m v3d_tpu_torch.apps.validate_ckpt --ckpt V3D_512.ckpt

The JAX CLI's later stages (forward parity against the live reference, the
full sampling loop, LPIPS / DPT ingestion) read a reference checkout and
are not part of the port.
"""

from __future__ import annotations

import argparse
from typing import Dict

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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ckpt", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu only when asked for)")
    args = p.parse_args(argv)
    check_conversion(args.ckpt, device=args.device)


if __name__ == "__main__":
    main()
