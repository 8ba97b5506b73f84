"""imgs2poses — run COLMAP structure-from-motion over a directory of images
and leave a sparse model that `data.scene_datasets.load_colmap_scene` (and the
scene-recon entry points) can consume.  A port of v3d_tpu/apps/imgs2poses.py.

Counterpart of the reference's mesh_recon/scripts/imgs2poses.py:12-70 (the
LLFF-derived colmap wrapper): feature_extractor -> matcher -> mapper, skipped
when `sparse/0/{cameras,images,points3D}` already exist.  The COLMAP binary is
a host-side tool (not bundled); when it is absent we fail with an actionable
message instead of a stack trace.

Beyond the reference script we also verify the produced model loads through
our reader and print a one-line summary (cameras/images/points), so a broken
run is caught here and not three steps later inside a trainer.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

from v3d_tpu_torch.data.colmap import read_model

MATCHERS = ("exhaustive_matcher", "sequential_matcher")


def _run(args, logfile) -> None:
    out = subprocess.check_output(args, universal_newlines=True,
                                  stderr=subprocess.STDOUT)
    logfile.write(out)
    logfile.flush()


def run_colmap(scene_dir: str, match_type: str = "exhaustive_matcher",
               colmap_bin: str = "colmap", single_camera: bool = True) -> None:
    """feature_extractor -> match_type -> mapper into scene_dir/sparse.

    Mapper flags follow the reference (init_min_tri_angle=4, single model,
    no color extraction); `--output_path` is the colmap>=3.6 spelling.
    """
    if shutil.which(colmap_bin) is None:
        raise FileNotFoundError(
            f"COLMAP binary {colmap_bin!r} not on PATH. Install colmap "
            "(https://colmap.github.io) or pass --colmap-bin; this step is "
            "host-side preprocessing, independent of the TPU runtime.")

    db = os.path.join(scene_dir, "database.db")
    images = os.path.join(scene_dir, "images")
    if not os.path.isdir(images):
        raise FileNotFoundError(f"{images} missing: put input frames in "
                                "<scene_dir>/images/")
    sparse = os.path.join(scene_dir, "sparse")
    os.makedirs(sparse, exist_ok=True)

    with open(os.path.join(scene_dir, "colmap_output.txt"), "w") as log:
        _run([colmap_bin, "feature_extractor",
              "--database_path", db, "--image_path", images,
              "--ImageReader.single_camera", "1" if single_camera else "0"],
             log)
        print("features extracted", flush=True)
        _run([colmap_bin, match_type, "--database_path", db], log)
        print("features matched", flush=True)
        _run([colmap_bin, "mapper",
              "--database_path", db, "--image_path", images,
              "--output_path", sparse,
              "--Mapper.init_min_tri_angle", "4",
              "--Mapper.multiple_models", "0",
              "--Mapper.extract_colors", "0"], log)
        print("sparse map created", flush=True)


def model_exists(scene_dir: str) -> bool:
    """True when sparse/0 already holds a full (bin or txt) model."""
    model = os.path.join(scene_dir, "sparse", "0")
    if not os.path.isdir(model):
        return False
    have = set(os.listdir(model))
    for ext in (".bin", ".txt"):
        if {f"cameras{ext}", f"images{ext}", f"points3D{ext}"} <= have:
            return True
    return False


def gen_poses(scene_dir: str, match_type: str = "exhaustive_matcher",
              colmap_bin: str = "colmap") -> dict:
    """Ensure a sparse model exists, load it back, return a summary dict."""
    if model_exists(scene_dir):
        print("existing sparse model found — skipping COLMAP", flush=True)
    else:
        run_colmap(scene_dir, match_type, colmap_bin)

    cams, imgs, pts = read_model(os.path.join(scene_dir, "sparse", "0"))
    summary = {"cameras": len(cams), "images": len(imgs),
               "points3d": 0 if pts is None else int(pts[0].shape[0])}
    print(f"model OK: {summary['cameras']} cameras, {summary['images']} "
          f"images, {summary['points3d']} points", flush=True)
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("scene_dir", help="scene root containing images/")
    p.add_argument("--match-type", default="exhaustive_matcher",
                   choices=MATCHERS)
    p.add_argument("--colmap-bin", default="colmap")
    a = p.parse_args(argv)
    try:
        gen_poses(a.scene_dir, a.match_type, a.colmap_bin)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
