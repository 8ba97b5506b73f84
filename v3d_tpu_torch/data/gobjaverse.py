"""GObjaverse: the real archive layout of the reference's primary training
set (sgm/data/objaverse.py:188-424 ``GObjaverse``); a port of the JAX
package's ``data/gobjaverse.py``, numpy on the host.

Layout on disk::

    root/valid_uids.json                      list of ids ("0/10010", ...)
    root/gobjaverse/<id>/<v:05d>/<v:05d>.png  RGBA render, 24 views/object
    root/gobjaverse/<id>/<v:05d>/<v:05d>.json camera ({x,y,z,origin,
                                              x_fov,y_fov,bbox,...})
    root/latents256/<id>.pt                   (24,4,32,32) VAE latents
    root/clip_emb256/<id>.pt                  (24,1,1024) CLIP embeddings
    root/clip_score_per_view.pt               {id: (24,) score} (front-view
                                              selection by CLIP score)
    root/text_captions_cap3d.json             {id: caption}

``.pt`` sidecars are torch saves in the original archive; ``.npy``/``.npz``
equivalents are accepted as well.

Faithful semantics (file:line refs into the reference):
- front-view selection random / fixed / clip_score_softmax / clip_score_max
  via np.roll of the view list (objaverse.py:236-282)
- lognormal cond_aug  exp(N(mean, std))  (objaverse.py:312-314)
- white-background alpha blend + resize + [-1,1] (objaverse.py:152-163,
  ObjaverseSpiralDataset transform :814-821)
- corrupt-item fallback to idx 0 (objaverse.py:288-306)
- pixelnerf 25-dim cameras: 4x4 OpenGL c2w (16) + intrinsics normalized by
  w,h (9) (objaverse.py:93-115 build_camera_standard, :360-396), optional
  pose normalization center+1.5/radius (:396-403)
- collate: multi-cond source sampling (objaverse.py:407-424) then
  video_collate_fn flattening (b t)->bt (objaverse.py:166-186)
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from v3d_tpu_torch.data.objaverse import video_collate

N_VIEWS = 24


# ---------------------------------------------------------------------------
# camera json parsing (objaverse.py:14-58)
# ---------------------------------------------------------------------------

def read_camera_matrix_single(json_file: str) -> np.ndarray:
    """gobjaverse per-view camera json -> (3,4) c2w with the OpenCV->OpenGL
    sign flip on the y/z columns (objaverse.py:14-35)."""
    with open(json_file, "r", encoding="utf8") as f:
        j = json.load(f)
    m = np.zeros((3, 4), np.float32)
    m[:3, 0] = np.asarray(j["x"], np.float32)
    m[:3, 1] = -np.asarray(j["y"], np.float32)
    m[:3, 2] = -np.asarray(j["z"], np.float32)
    m[:3, 3] = np.asarray(j["origin"], np.float32)
    return m


def read_camera_intrinsics_single(json_file: str, h: int, w: int,
                                  scale: float = 1.0) -> np.ndarray:
    """-> (3,2) [[fx,fy],[cx,cy],[w,h]] from x_fov/y_fov (objaverse.py:37-58)."""
    with open(json_file, "r", encoding="utf8") as f:
        j = json.load(f)
    h, w = int(h * scale), int(w * scale)
    fy = h / 2 / np.tan(j["y_fov"] / 2)
    fx = w / 2 / np.tan(j["x_fov"] / 2)
    return np.asarray([[fx, fy], [w // 2, h // 2], [w, h]], np.float32)


def build_camera_standard(RT: np.ndarray, intrinsics: np.ndarray) -> np.ndarray:
    """(N,3,4) extrinsics + (N,3,2) intrinsics -> (N,25) pixelnerf cameras:
    16 = homogeneous c2w, 9 = [[fx,0,cx],[0,fy,cy],[0,0,1]] normalized by
    width/height (objaverse.py:64-115)."""
    n = RT.shape[0]
    e = np.concatenate(
        [RT, np.tile(np.asarray([[[0, 0, 0, 1.0]]], np.float32), (n, 1, 1))],
        axis=1)
    fx = intrinsics[:, 0, 0] / intrinsics[:, 2, 0]
    fy = intrinsics[:, 0, 1] / intrinsics[:, 2, 1]
    cx = intrinsics[:, 1, 0] / intrinsics[:, 2, 0]
    cy = intrinsics[:, 1, 1] / intrinsics[:, 2, 1]
    z = np.zeros_like(fx)
    o = np.ones_like(fx)
    i9 = np.stack([fx, z, cx, z, fy, cy, z, z, o], axis=-1)
    return np.concatenate([e.reshape(n, 16), i9], axis=-1).astype(np.float32)


def calc_elevation(c2w: np.ndarray) -> np.ndarray:
    """arcsin(z / |pos|), world up (0,0,1) (objaverse.py:117-123)."""
    pos = c2w[..., :3, 3]
    return np.arcsin(pos[..., 2] / np.linalg.norm(pos, axis=-1))


def normalize_poses(cameras: np.ndarray, target_radius: float = 1.5
                    ) -> np.ndarray:
    """scale_pose (objaverse.py:396-403): center camera positions, scale so
    the farthest is at ``target_radius``.  cameras: (N,25), modified copy."""
    cameras = cameras.copy()
    c2ws = cameras[..., :16].reshape(-1, 4, 4)
    center = c2ws[:, :3, 3].mean(axis=0)
    radius = np.linalg.norm(c2ws[:, :3, 3] - center, axis=-1).max()
    c2ws[:, :3, 3] = (c2ws[:, :3, 3] - center) * (
        target_radius / max(radius, 1e-8))
    cameras[..., :16] = c2ws.reshape(-1, 16)
    return cameras


# ---------------------------------------------------------------------------
# sidecar loading (.pt via torch when present, else .npy/.npz)
# ---------------------------------------------------------------------------

def _load_tensor_file(path_no_ext: str) -> Optional[np.ndarray]:
    if os.path.exists(path_no_ext + ".npy"):
        return np.load(path_no_ext + ".npy")
    if os.path.exists(path_no_ext + ".pt"):
        import torch
        return torch.load(path_no_ext + ".pt", map_location="cpu",
                          weights_only=True).float().numpy()
    return None


def _load_score_table(root: str) -> Optional[Dict[str, np.ndarray]]:
    pt = os.path.join(root, "clip_score_per_view.pt")
    nz = os.path.join(root, "clip_score_per_view.npz")
    if os.path.exists(nz):
        with np.load(nz) as z:
            return {k: z[k] for k in z.files}
    if os.path.exists(pt):
        import torch
        table = torch.load(pt, map_location="cpu", weights_only=True)
        return {k: np.asarray(v, np.float32) for k, v in table.items()}
    return None


def _blend_white_and_resize(png_path: str, reso: int) -> np.ndarray:
    """RGBA -> white-composited RGB in [-1,1] at reso^2
    (objaverse.py:152-163 + datamodule transform :814-821)."""
    from PIL import Image

    from v3d_tpu_torch.native.imgdec import decode_image

    arr = decode_image(png_path)  # native decode (threaded C++), PIL fallback
    img = Image.fromarray(arr, "RGBA") if arr is not None else Image.open(png_path)
    bg = Image.new("RGB", img.size, (255, 255, 255))
    if img.mode == "RGBA":
        bg.paste(img, mask=img.split()[3])
    else:
        bg.paste(img)
    bg = bg.resize((reso, reso), Image.BILINEAR)
    return np.asarray(bg, np.float32) / 127.5 - 1.0


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max())
    return e / e.sum()


class GObjaverse:
    """The real-layout loader.  Items are dicts in the reference's field
    convention; frames are (T,H,W,3) channels-last in [-1,1]."""

    def __init__(self, root_dir: str, reso: int = 256,
                 cond_aug_mean: float = -3.0, cond_aug_std: float = 0.5,
                 fps_id: float = 0.0, motion_bucket_id: float = 300.0,
                 use_latents: bool = False, load_caps: bool = False,
                 front_view_selection: str = "random",
                 load_pixelnerf: bool = False, scale_pose: bool = False,
                 condition_on_elevation: bool = False,
                 max_n_cond: int = 1, max_item: Optional[int] = None,
                 seed: int = 0):
        self.root = root_dir
        self.reso = reso
        self.cond_aug_mean = cond_aug_mean
        self.cond_aug_std = cond_aug_std
        self.fps_id = fps_id
        self.motion_bucket_id = motion_bucket_id
        self.use_latents = use_latents
        self.load_caps = load_caps
        self.load_pixelnerf = load_pixelnerf
        self.scale_pose = scale_pose
        self.condition_on_elevation = condition_on_elevation
        self.max_n_cond = max_n_cond
        self.rng = np.random.RandomState(seed)

        with open(os.path.join(root_dir, "valid_uids.json")) as f:
            self.ids: List[str] = json.load(f)

        self.front_view_selection = front_view_selection
        self.clip_scores = None
        if front_view_selection.startswith("clip_score"):
            self.clip_scores = _load_score_table(root_dir)
            if self.clip_scores is None:
                raise FileNotFoundError(
                    f"{front_view_selection} needs clip_score_per_view in "
                    f"{root_dir}")
            self.ids = list(self.clip_scores.keys())
        elif front_view_selection not in ("random", "fixed"):
            raise ValueError(front_view_selection)

        if self.load_caps:
            with open(os.path.join(root_dir, "text_captions_cap3d.json")) as f:
                self.caps = json.load(f)

        if max_item is not None:
            self.ids = self.ids[:max_item]

    def __len__(self) -> int:
        return len(self.ids)

    def _view_order(self, idx: int) -> np.ndarray:
        order = np.arange(N_VIEWS)
        sel = self.front_view_selection
        if sel == "random":
            return np.roll(order, int(self.rng.randint(N_VIEWS)))
        if sel == "fixed":
            return order
        scores = _softmax(np.asarray(self.clip_scores[self.ids[idx]],
                                     np.float32))
        if sel == "clip_score_softmax":
            return np.roll(order, int(self.rng.choice(order, p=scores)))
        return np.roll(order, int(np.argmax(scores)))  # clip_score_max

    def _frame_dir(self, idx: int, view: int) -> str:
        return os.path.join(self.root, "gobjaverse", self.ids[idx],
                            f"{view:05d}")

    def _load_item(self, idx: int) -> Dict:
        order = self._view_order(idx)
        data: Dict = {}
        if self.use_latents:
            lat = _load_tensor_file(
                os.path.join(self.root, "latents256", self.ids[idx]))
            emb = _load_tensor_file(
                os.path.join(self.root, "clip_emb256", self.ids[idx]))
            if lat is None or emb is None:
                raise FileNotFoundError(f"latents for {self.ids[idx]}")
            lat = np.asarray(lat, np.float32)[order]
            if lat.shape[1] <= 8 and lat.shape[1] < lat.shape[-1]:
                lat = np.moveaxis(lat, 1, -1)  # torch (T,4,h,w) -> (T,h,w,4)
            clip_emb = np.asarray(emb, np.float32)[order][0]
            cond = lat[0]
            data["latents"] = lat
            data["cond_frames_without_noise"] = clip_emb
        else:
            frames = np.stack([
                _blend_white_and_resize(
                    os.path.join(self._frame_dir(idx, v), f"{v:05d}.png"),
                    self.reso)
                for v in order])
            cond = frames[0]
            data["frames"] = frames
            data["cond_frames_without_noise"] = cond

        cond_aug = float(np.exp(
            self.rng.randn() * self.cond_aug_std + self.cond_aug_mean))
        data["cond_frames"] = (
            cond + cond_aug * self.rng.randn(*cond.shape).astype(np.float32))
        data["cond_aug"] = np.full((N_VIEWS,), cond_aug, np.float32)
        data["fps_id"] = np.full((N_VIEWS,), self.fps_id, np.float32)
        data["motion_bucket_id"] = np.full(
            (N_VIEWS,), self.motion_bucket_id, np.float32)
        data["image_only_indicator"] = np.zeros((N_VIEWS,), np.float32)
        data["num_video_frames"] = N_VIEWS

        if self.condition_on_elevation:
            c2w = read_camera_matrix_single(
                os.path.join(self._frame_dir(idx, 0), "00000.json"))
            data["elevation"] = np.full(
                (N_VIEWS,), calc_elevation(c2w), np.float32)

        if self.load_pixelnerf:
            assert "frames" in data, "pixelnerf needs frames, not latents"
            rts, intr = [], []
            for v in order:
                meta = os.path.join(self._frame_dir(idx, v), f"{v:05d}.json")
                rts.append(read_camera_matrix_single(meta))
                intr.append(read_camera_intrinsics_single(meta, 256, 256))
            cameras = build_camera_standard(np.stack(rts), np.stack(intr))
            if self.scale_pose:
                cameras = normalize_poses(cameras)
            # 32x32 downsampled rgb in [0,1] (objaverse.py:380-390)
            small = np.stack([
                _blend_white_and_resize(
                    os.path.join(self._frame_dir(idx, v), f"{v:05d}.png"), 32)
                for v in order]) * 0.5 + 0.5
            data["pixelnerf_input"] = {
                "cameras": cameras,
                "rgb": small.astype(np.float32),
                "frames": data["frames"],
            }

        if self.load_caps:
            data["caption"] = self.caps[self.ids[idx]]
            data["ids"] = self.ids[idx]
        return data

    def __getitem__(self, idx: int) -> Dict:
        try:
            return self._load_item(idx)
        except Exception:
            if idx == 0:
                raise
            # corrupt-item workaround (objaverse.py:288-306)
            return self._load_item(0)

    def collate_fn(self, items: Sequence[Dict]) -> Dict:
        """Multi-cond source sampling + video collate (objaverse.py:407-424)."""
        if self.max_n_cond > 1:
            n_cond = int(self.rng.randint(1, self.max_n_cond + 1))
            if n_cond > 1:
                for it in items:
                    src = [0] + self.rng.choice(
                        np.arange(1, N_VIEWS), self.max_n_cond - 1,
                        replace=False).tolist()
                    pn = it["pixelnerf_input"]
                    pn["source_index"] = np.asarray(src, np.int32)
                    pn["n_cond"] = n_cond
                    pn["source_images"] = it["frames"][src]
                    pn["source_cameras"] = pn["cameras"][src]
        return video_collate(items)

    def iter_batches(self, batch_size: int,
                     shuffle: bool = True) -> Iterator[Dict]:
        order = np.arange(len(self))
        while True:
            if shuffle:
                self.rng.shuffle(order)
            for s in range(0, len(order) - batch_size + 1, batch_size):
                yield self.collate_fn([self[int(i)]
                                       for i in order[s:s + batch_size]])
