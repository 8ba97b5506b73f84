"""Checkpoint validation, first stage (counterpart of
v3d_tpu/apps/validate_ckpt.py:35-58, ``check_conversion``): split a V3D /
SVD checkpoint on its key prefixes, count keys and parameters per part,
load it strictly into the port's V3D-512 engine and check that the UNet's
parameter count equals the checkpoint's UNet subtree.

    python -m v3d_tpu_torch.apps.validate_ckpt --ckpt V3D_512.ckpt \
        [--lpips lpips_vgg.npz] [--dpt omnidata_dpt.ckpt]

``--lpips`` / ``--dpt`` (validate_ckpt.py:442-450): load the LPIPS .npz or
the DPT weights and make one call on the device.

``--all DIR --report PATH`` (validate_ckpt.py:239-409, ``check_all``): every
recognised file in DIR goes through its stage (``conversion`` for the main
checkpoint, ``lpips_ingest``, ``dpt_ingest``, ``u2net_ingest``,
``clip_ingest`` through the CLIP key map); an absent artifact becomes a
``plan`` entry, a failed stage an error in the report; the report is one
JSON file, ``ok`` when every stage that ran passed, and the exit code is 1
when it is not.  The JAX CLI's ``--forward``, ``--full-loop`` and
``--all``'s ``forward_parity`` / ``sampling_loop_40db`` stages read a
checkout of the reference, and ``--refpoint-fit`` runs the JAX package's
quality bench; the port has none of them.
"""

from __future__ import annotations

import argparse
import math
import sys
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


def check_clip(path: str) -> int:
    """An open_clip visual tower (.npz, or a torch file, open_clip key
    names): every key through the CLIP key map (unknown keys raise, as the
    JAX converter does), then a strict load into ``CLIPVisionTransformer``
    at the file's shapes; returns its parameter count."""
    from v3d_tpu_torch.core.keymap import convert_clip_key
    from v3d_tpu_torch.models.clip_vit import CLIPVisionTransformer

    if path.endswith(".npz"):
        with np.load(path) as z:
            sd = {k: torch.from_numpy(z[k]) for k in z.files}
    else:
        sd = load_torch_state_dict(path)
    unknown = [k for k in sd if convert_clip_key(k) is None]
    if unknown:
        raise KeyError(f"unrecognized CLIP keys: {unknown[:10]}")
    width = sd["class_embedding"].shape[0]
    patch = sd["conv1.weight"].shape[-1]
    grid = math.isqrt(sd["positional_embedding"].shape[0] - 1)
    layers = len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks.")})
    # the head count shapes no weight: one head loads every tensor
    model = CLIPVisionTransformer(width=width, layers=layers, heads=1,
                                  patch_size=patch, image_size=grid * patch,
                                  output_dim=sd["proj"].shape[1])
    model.load_state_dict(sd, strict=True)
    return sum(int(v.numel()) for v in model.state_dict().values())


def check_all(ckpt_dir: str, report_path: str, device="cuda", engine=None) -> Dict:
    """One report for a directory of weights (validate_ckpt.py:239-409):

      V3D_512.ckpt / svd_xt.safetensors  -> conversion
      lpips_vgg.npz / vgg16.npz          -> LPIPS ingestion + one distance
      omnidata_dpt_normal.ckpt/.npz      -> DPT normal predictor + one frame
      u2net.pth / u2net.npz              -> U2Net background removal
      open_clip_vit_h.npz                -> CLIP tower through its key map

    A file that is absent becomes a ``plan`` entry (what it unlocks, the
    command that runs it); a stage that raises is recorded with its error
    and the next one runs.  ``ok``: every stage that ran passed.  ``engine``
    is handed to ``check_conversion`` (default: the V3D-512 engine)."""
    import glob
    import json
    import os
    import time

    report = {"dir": ckpt_dir, "stages": {}, "t_start": time.time()}

    def stage(name, fn):
        t0 = time.time()
        try:
            out = fn()
            report["stages"][name] = {"ok": True, "detail": out,
                                      "s": round(time.time() - t0, 1)}
            print(f"[all] {name}: OK ({time.time() - t0:.0f}s)")
        except Exception as e:  # keep going: one report for the whole directory
            report["stages"][name] = {"ok": False, "error": str(e)[:500],
                                      "s": round(time.time() - t0, 1)}
            print(f"[all] {name}: FAIL - {e}")

    def find(*patterns):
        for pat in patterns:
            hits = sorted(glob.glob(os.path.join(ckpt_dir, pat)))
            if hits:
                return hits[0]
        return None

    main_ckpt = find("V3D_512.ckpt", "*.ckpt", "svd_xt*.safetensors",
                     "*.safetensors")
    lpips_w = find("lpips_vgg*.npz", "vgg16*.npz", "vgg*.npz")
    dpt_w = find("omnidata*dpt*", "dpt*.npz", "dpt*.ckpt")
    u2net_w = find("u2net*.npz", "u2net*.pth")
    clip_w = find("*clip*.npz")

    plan = []
    rerun = f"python -m v3d_tpu_torch.apps.validate_ckpt --all {ckpt_dir}"

    def planned(artifact, looked_for, gate, command):
        plan.append({"artifact": artifact, "looked_for": looked_for,
                     "gate": gate, "command": command})
        print(f"[plan] {artifact}: ABSENT (looked for {looked_for})\n"
              f"       gate: {gate}\n"
              f"       run:  {command}")

    if main_ckpt:
        stage("conversion",
              lambda: check_conversion(main_ckpt, engine, device) and "converted")
    else:
        planned(
            "V3D_512.ckpt / svd_xt.safetensors",
            "V3D_512.ckpt, *.ckpt, svd_xt*.safetensors, *.safetensors",
            "key-prefix split conversion (V3D_512.py:145-162): every key "
            "loads strictly into the V3D-512 engine, UNet parameter count "
            "equal to the checkpoint's UNet subtree", rerun)
    if not lpips_w:
        planned(
            "LPIPS VGG weights", "lpips_vgg*.npz, vgg16*.npz, vgg*.npz",
            "LPIPS ingestion smoke + the V3D readme step-4 recipe's "
            "perceptual term: lambda_dssim=1.0 lambda_lpips=2.0 fit "
            "(train_from_vid.py:130-137)",
            f"V3D_TPU_LPIPS_WEIGHTS={ckpt_dir}/lpips_vgg.npz python -m "
            "v3d_tpu_torch.apps.recon_gs --video ORBIT.mp4 --output OUT "
            "--lambda-dssim 1.0 --lambda-lpips 2.0   (and: " + rerun + ")")
    if not dpt_w:
        planned(
            "omnidata DPT normal ckpt", "omnidata*dpt*, dpt*.npz, dpt*.ckpt",
            "DPT normal-predictor ingestion; unlocks NeuS normal "
            "supervision (mesh_recon/datasets/v3d.py:173)", rerun)
    if not u2net_w:
        planned(
            "U2Net weights", "u2net*.npz, u2net*.pth",
            "background-removal (rembg-equivalent) ingestion for "
            "preprocessing (V3D_512.py:210)", rerun)
    if not clip_w:
        planned(
            "OpenCLIP ViT-H visual tower", "*clip*.npz",
            "CLIP conditioner + safety-head ingestion "
            "(encoders/modules.py:594; p_head/w_head npz)", rerun)

    if lpips_w:
        stage("lpips_ingest",
              lambda: f"lpips(black, gray)={check_lpips(lpips_w, device):.4f}")
    if dpt_w:
        stage("dpt_ingest", lambda: check_dpt(dpt_w, device) is not None and dpt_w)

    if u2net_w:
        def _u2net():
            from v3d_tpu_torch.models.u2net import load_u2net

            if load_u2net(u2net_w, device=device) is None:
                raise FileNotFoundError(u2net_w)
            return u2net_w
        stage("u2net_ingest", _u2net)
    if clip_w:
        stage("clip_ingest", lambda: f"{check_clip(clip_w) / 1e6:.1f}M clip params")

    report["wall_s"] = round(time.time() - report["t_start"], 1)
    del report["t_start"]
    report["plan"] = plan
    # ok = every stage that ran passed; absent artifacts are plan entries
    report["ok"] = all(s.get("ok") for s in report["stages"].values())
    with open(report_path, "w") as f:
        json.dump(report, f, indent=1)
    status = "ALL OK" if report["ok"] else "FAILURES PRESENT"
    if plan:
        status += f"; {len(plan)} artifact(s) absent -> plan above"
    print(f"[all] report -> {report_path}  ({status})")
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ckpt", default=None, help="svd_xt.safetensors or V3D_512.ckpt")
    p.add_argument("--all", default=None, metavar="CKPT_DIR",
                   help="validate every recognised file in the directory and "
                        "write one report")
    p.add_argument("--report", default="validate_ckpt_report.json",
                   help="report path for --all")
    p.add_argument("--lpips", default=None, help="LPIPS VGG .npz to ingest")
    p.add_argument("--dpt", default=None, help="Omnidata DPT .ckpt / .npz to ingest")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu only when asked for)")
    args = p.parse_args(argv)
    if args.all:
        report = check_all(args.all, args.report, args.device)
        sys.exit(0 if report["ok"] else 1)
    if not (args.ckpt or args.lpips or args.dpt):
        p.error("need --ckpt, --lpips, --dpt or --all")
    if args.ckpt:
        check_conversion(args.ckpt, device=args.device)
    if args.lpips:
        check_lpips(args.lpips, args.device)
    if args.dpt:
        check_dpt(args.dpt, args.device)
    print("validate_ckpt: done")


if __name__ == "__main__":
    main()
