"""Scene-level datasets for training and reconstruction (a port of the JAX
package's ``data/scene_datasets.py``, numpy on the host).

Counterparts of:
- mesh_recon/datasets/blender.py (NeRF-synthetic transforms.json)
- mesh_recon/datasets/videonvs.py (re-rendered spirals + transforms_train.json)
- sgm/data/co3d.py + mvimagenet.py (scene orbits with per-frame poses;
  pixelnerf camera tensors, 25-dim = 16 c2w + 9 K, objaverse.py:360-396)
- recon COLMAP scenes (via data.colmap)

Real CO3D/MVImageNet archives aren't present in this environment; these
loaders implement the on-disk contracts (json poses, colmap models, frame
dirs) so data drops in, and the camera-tensor math used by the
camera-conditioned (PixelNeRF) variant.

DTU's P = K [R | t] is decomposed in numpy (``decompose_projection``), with
the conventions of cv2.decomposeProjectionMatrix, which the JAX loader
calls.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np

from v3d_tpu_torch.data.cam_paths import normalize_scene_poses
from v3d_tpu_torch.data.cameras import fov2focal


@dataclasses.dataclass
class SceneFrames:
    images: np.ndarray      # (N, H, W, 3) float [0,1]
    c2ws: np.ndarray        # (N, 4, 4) (OpenGL if ``opengl``)
    intrinsics: np.ndarray  # (N, 3, 3)
    fg_masks: Optional[np.ndarray] = None
    opengl: bool = True

    @property
    def num_frames(self) -> int:
        return len(self.images)


def camera_tensor(c2w: np.ndarray, K: np.ndarray) -> np.ndarray:
    """25-dim pixelnerf camera embedding: 16 flattened c2w + 9 flattened K
    (sgm/data/objaverse.py:360-396)."""
    return np.concatenate([c2w.reshape(16), K.reshape(9)]).astype(np.float32)


def load_blender_scene(root: str, split: str = "train",
                       white_background: bool = True) -> SceneFrames:
    """NeRF-synthetic: transforms_{split}.json with camera_angle_x + frames
    (mesh_recon/datasets/blender.py)."""
    from PIL import Image

    with open(os.path.join(root, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    images, poses, masks = [], [], []
    for fr in meta["frames"]:
        path = os.path.join(root, fr["file_path"])
        if not os.path.splitext(path)[1]:
            path += ".png"
        img = np.asarray(Image.open(path), np.float32) / 255.0
        if img.shape[-1] == 4:
            masks.append(img[..., 3])
            bg = 1.0 if white_background else 0.0
            img = img[..., :3] * img[..., 3:] + bg * (1 - img[..., 3:])
        else:
            masks.append(np.ones(img.shape[:2], np.float32))
        images.append(img)
        poses.append(np.asarray(fr["transform_matrix"], np.float32))
    images = np.stack(images)
    h, w = images.shape[1:3]
    focal = fov2focal(meta["camera_angle_x"], w)
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)
    return SceneFrames(images, np.stack(poses),
                       np.repeat(K[None], len(images), 0),
                       np.stack(masks), opengl=True)


def load_videonvs_scene(root: str) -> SceneFrames:
    """Re-rendered 3DGS spiral scenes (mesh_recon/datasets/videonvs.py):
    same layout as blender with transforms_train.json."""
    return load_blender_scene(root, "train")


def load_colmap_scene(root: str, images_dir: str = "images",
                      sparse_dir: str = "sparse/0") -> SceneFrames:
    """COLMAP workspace -> SceneFrames (OpenCV poses converted to OpenGL)."""
    from PIL import Image

    from v3d_tpu_torch.data.colmap import read_model

    cams, imgs, _ = read_model(os.path.join(root, sparse_dir))
    images, poses, Ks = [], [], []
    for iid in sorted(imgs, key=lambda i: imgs[i].name):
        im = imgs[iid]
        img = np.asarray(Image.open(
            os.path.join(root, images_dir, im.name)).convert("RGB"),
            np.float32) / 255.0
        cam = cams[im.camera_id]
        if cam.model == "SIMPLE_PINHOLE":
            f, cx, cy = cam.params[:3]
            fx = fy = f
        else:
            fx, fy, cx, cy = cam.params[:4]
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        c2w = im.c2w()
        c2w[:, 1:3] *= -1  # OpenCV -> OpenGL
        images.append(img)
        poses.append(c2w)
        Ks.append(K)
    return SceneFrames(np.stack(images), np.stack(poses), np.stack(Ks),
                       opengl=True)


@dataclasses.dataclass
class SceneOrbitConfig:
    """CO3D/MVImageNet-style training config (co3d.py CO3Dv2Wrapper:315 —
    num_frames=20, max_n_cond=5; mvimagenet.py MVImageNet:56)."""

    num_frames: int = 20
    max_n_cond: int = 5
    cond_aug: float = 0.02
    fps_id: float = 1.0
    motion_bucket_id: float = 300.0
    target_radius: float = 1.5


class SceneOrbitDataset:
    """Turns posed scene captures into V3D-style video training items with
    pixelnerf camera tensors; root contains one SceneFrames-loadable dir per
    scene (blender/videonvs layout)."""

    def __init__(self, roots: List[str], cfg: SceneOrbitConfig = SceneOrbitConfig(),
                 loader=load_videonvs_scene, seed: int = 0):
        self.roots = roots
        self.cfg = cfg
        self.loader = loader
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.roots)

    def __getitem__(self, idx: int) -> Dict:
        scene = self.loader(self.roots[idx])
        cfg = self.cfg
        t = min(cfg.num_frames, scene.num_frames)
        # contiguous window, as the video loaders sample clips
        start = int(self.rng.randint(0, scene.num_frames - t + 1))
        sel = slice(start, start + t)
        images = scene.images[sel] * 2.0 - 1.0
        c2ws, scale = normalize_scene_poses(scene.c2ws[sel],
                                            cfg.target_radius)
        cams = np.stack([camera_tensor(c2ws[i], scene.intrinsics[sel][i])
                         for i in range(t)])
        cond = images[0]
        item = {
            "frames": images.astype(np.float32),
            "cond_frames_without_noise": cond,
            "cond_frames": cond + cfg.cond_aug * self.rng.randn(
                *cond.shape).astype(np.float32),
            "cameras": cams,
            "fps_id": np.full((t,), cfg.fps_id, np.float32),
            "motion_bucket_id": np.full((t,), cfg.motion_bucket_id, np.float32),
            "cond_aug": np.full((t,), cfg.cond_aug, np.float32),
            "image_only_indicator": np.zeros((t,), np.float32),
            "num_video_frames": t,
        }
        return item


def decompose_projection(P: np.ndarray):
    """P (3, 4) -> (K, R, c) as cv2.decomposeProjectionMatrix returns them:
    M = P[:, :3] = K R with K upper triangular, R a rotation (det +1),
    K[0, 0] and K[1, 1] positive (K[2, 2] carries the sign of det M), and
    c (4, 1) the homogeneous camera centre, the unit null vector of P.
    The RQ decomposition is a QR of the row-reversed transpose."""
    P = np.asarray(P, np.float64)
    flip = np.eye(3)[::-1]
    q, r = np.linalg.qr((flip @ P[:, :3]).T)
    K = flip @ r.T @ flip
    R = flip @ q.T
    signs = np.diag(np.sign(np.diag(K)))
    K, R = K @ signs, signs @ R
    if np.linalg.det(R) < 0:
        K[:, 2] *= -1
        R[2] *= -1
    c = np.linalg.svd(P)[2][-1]
    return K, R, c[:, None]


def load_dtu_scene(root: str, images_dir: str = "image",
                   masks_dir: str = "mask") -> SceneFrames:
    """DTU scenes with cameras.npz world_mat_N/scale_mat_N
    (mesh_recon/datasets/dtu.py): decompose P = K [R|t] and normalize."""
    from PIL import Image

    cams = np.load(os.path.join(root, "cameras.npz"))
    n = len([k for k in cams.files if k.startswith("world_mat_")
             and not k.startswith("world_mat_inv")])
    images, poses, Ks, masks = [], [], [], []
    for i in range(n):
        P = (cams[f"world_mat_{i}"] @ cams[f"scale_mat_{i}"])[:3, :4]
        K, R, t = decompose_projection(P)
        K = K / K[2, 2]
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = R.T
        c2w[:3, 3] = (t[:3] / t[3])[:, 0]
        c2w[:, 1:3] *= -1  # OpenCV -> OpenGL
        img_path = os.path.join(root, images_dir, f"{i:06d}.png")
        img = np.asarray(Image.open(img_path).convert("RGB"),
                         np.float32) / 255.0
        mask_path = os.path.join(root, masks_dir, f"{i:03d}.png")
        if os.path.exists(mask_path):
            m = np.asarray(Image.open(mask_path).convert("L"),
                           np.float32) / 255.0
        else:
            m = np.ones(img.shape[:2], np.float32)
        images.append(img)
        poses.append(c2w)
        Ks.append(K.astype(np.float32))
        masks.append(m)
    return SceneFrames(np.stack(images), np.stack(poses), np.stack(Ks),
                       np.stack(masks), opengl=True)


def load_co3d_scene(root: str, category: str, sequence: Optional[str] = None,
                    subset: str = "fewview_train", reso: int = 256,
                    num_frames: int = 0) -> SceneFrames:
    """One CO3D sequence as a posed scene (the videonvs_co3d scene path,
    mesh_recon/datasets/videonvs_co3d.py:212 + sgm/data/co3d.py frame
    machinery): box-cropped square frames, per-frame K, fg masks, OpenGL
    c2ws.  ``sequence=None`` picks the first sequence of the category."""
    from v3d_tpu_torch.data.co3d import Co3dDataset

    ds = Co3dDataset(root, category=category, subset=subset, reso=reso,
                     box_crop=True, load_pixelnerf=False, scale_pose=False)
    seq = sequence or ds.seq_list[0]
    idxs = ds.seq_to_frames[seq]
    if num_frames:
        idxs = [idxs[i] for i in
                np.linspace(0, len(idxs) - 1, num_frames).astype(int)]
    images, poses, Ks, masks = [], [], [], []
    for i in idxs:
        fr = ds._load_frame(ds.frames[i])
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = fr["R"]
        w2c[:3, 3] = fr["t"]
        c2w = np.linalg.inv(w2c)
        c2w[:, 1:3] *= -1  # OpenCV -> OpenGL
        images.append(fr["rgb"])
        poses.append(c2w.astype(np.float32))
        Ks.append(fr["K"].astype(np.float32))
        masks.append(fr["fg"])
    c2ws, _ = normalize_scene_poses(np.stack(poses), 1.5)
    return SceneFrames(np.stack(images), c2ws, np.stack(Ks),
                       np.stack(masks), opengl=True)
