"""COLMAP model readers (a copy of the JAX package's ``data/colmap.py``,
itself of sgm/data/colmap.py and recon/scene/colmap_loader.py): cameras /
images / points3D in binary or text format, used by the scene loaders,
MVImageNet and ``apps.imgs2poses``.  numpy only, on the host."""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict, Tuple

import numpy as np

from v3d_tpu_torch.data.cam_paths import matrix_from_quat

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray     # (w, x, y, z)
    tvec: np.ndarray
    camera_id: int
    name: str

    def w2c(self) -> np.ndarray:
        out = np.eye(4, dtype=np.float32)
        out[:3, :3] = matrix_from_quat(self.qvec)
        out[:3, 3] = self.tvec
        return out

    def c2w(self) -> np.ndarray:
        return np.linalg.inv(self.w2c()).astype(np.float32)


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, "<iiQQ")
            name, np_ = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "<" + "d" * np_))
            out[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return out


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            iid = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<dddd"))
            tvec = np.array(_read(f, "<ddd"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n2d,) = _read(f, "<Q")
            f.read(24 * n2d)  # skip 2D points (x, y, point3D_id)
            out[iid] = ColmapImage(iid, qvec, tvec, cam_id, name.decode())
    return out


def read_points3d_binary(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """-> (xyz (N,3), rgb (N,3))."""
    xyzs, rgbs = [], []
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            _pid = _read(f, "<Q")
            xyz = _read(f, "<ddd")
            rgb = _read(f, "<BBB")
            _err = _read(f, "<d")
            (track_len,) = _read(f, "<Q")
            f.read(8 * track_len)
            xyzs.append(xyz)
            rgbs.append(rgb)
    return np.asarray(xyzs, np.float32), np.asarray(rgbs, np.uint8)


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            cid = int(parts[0])
            out[cid] = ColmapCamera(cid, parts[1], int(parts[2]),
                                    int(parts[3]),
                                    np.array([float(x) for x in parts[4:]]))
    return out


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path) as f:
        lines = [l for l in f if not l.startswith("#") and l.strip()]
    for i in range(0, len(lines), 2):  # every image has a second 2D-point line
        parts = lines[i].split()
        out[int(parts[0])] = ColmapImage(
            int(parts[0]), np.array([float(x) for x in parts[1:5]]),
            np.array([float(x) for x in parts[5:8]]), int(parts[8]), parts[9])
    return out


def read_model(sparse_dir: str):
    """Auto-detect binary/text model (recon/scene/colmap_loader.py)."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cams = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
        imgs = read_images_binary(os.path.join(sparse_dir, "images.bin"))
        pts = None
        p3d = os.path.join(sparse_dir, "points3D.bin")
        if os.path.exists(p3d):
            pts = read_points3d_binary(p3d)
        return cams, imgs, pts
    cams = read_cameras_text(os.path.join(sparse_dir, "cameras.txt"))
    imgs = read_images_text(os.path.join(sparse_dir, "images.txt"))
    return cams, imgs, None


def write_model(sparse_dir: str, cameras: Dict[int, ColmapCamera],
                images: Dict[int, ColmapImage],
                points: Tuple[np.ndarray, np.ndarray] = None) -> None:
    """The binary model ``read_model`` reads: cameras.bin, images.bin (no 2D
    points) and, given (xyz (N, 3), rgb (N, 3) uint8), points3D.bin (empty
    tracks, error 0).  Camera models by name, as ``CAMERA_MODELS`` lists."""
    ids = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}
    os.makedirs(sparse_dir, exist_ok=True)
    with open(os.path.join(sparse_dir, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cid, cam in cameras.items():
            f.write(struct.pack("<iiQQ", cid, ids[cam.model], cam.width, cam.height))
            f.write(struct.pack("<" + "d" * len(cam.params), *cam.params))
    with open(os.path.join(sparse_dir, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for iid, im in images.items():
            f.write(struct.pack("<i", iid))
            f.write(struct.pack("<dddd", *im.qvec))
            f.write(struct.pack("<ddd", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
    if points is None:
        return
    xyz, rgb = points
    with open(os.path.join(sparse_dir, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for pid, (p, c) in enumerate(zip(xyz, rgb)):
            f.write(struct.pack("<Q", pid))
            f.write(struct.pack("<ddd", *map(float, p)))
            f.write(struct.pack("<BBB", *map(int, c)))
            f.write(struct.pack("<dQ", 0.0, 0))
