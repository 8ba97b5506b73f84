"""MVImageNet training dataset — real archive format
(sgm/data/mvimagenet.py:56-339 ``MVImageNet``); a port of the JAX package's
``data/mvimagenet.py``, numpy on the host.

Layout on disk (raw MVImgNet distribution)::

    root/<class_id>/<scene_id>/images/*.jpg          casual orbit video
    root/<class_id>/<scene_id>/sparse/0/images.bin   COLMAP poses
    root/<class_id>/<scene_id>/sparse/0/cameras.bin  SIMPLE_RADIAL intrinsics
    root/<class_id>/<scene_id>/images/<name>_rembg.png  (optional cached
                                                         alpha mattes)

Faithful semantics (refs into the reference file):
- scenes = all ``*/*`` directories; missing sparse/0 falls back to scene 0
  (:118-124)
- frames sorted by COLMAP image name, mirror-extended to num_frames
  (:142-152)
- square crop: "random" offset or "rembg"-mask-centered with border
  clamping (:163-213); resize to reso; [-1,1]
- pixelnerf cameras: qvec/tvec -> c2w with OpenGL column flips
  (qt2c2w :41-49), SIMPLE_RADIAL f/cx/cy normalized by the crop size and
  shifted by the crop offset (:223-237); 25-dim tensors; optional pose
  normalization (scale_pose)
- item fields + lognormal cond_aug identical to GObjaverse (:246-262)
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Iterator, Sequence

import numpy as np

from v3d_tpu_torch.data.cam_paths import matrix_from_quat
from v3d_tpu_torch.data.colmap import read_cameras_binary, read_images_binary
from v3d_tpu_torch.data.gobjaverse import normalize_poses
from v3d_tpu_torch.data.objaverse import video_collate


def qt2c2w(qvec: np.ndarray, tvec: np.ndarray) -> np.ndarray:
    """COLMAP (w2c quaternion, translation) -> OpenGL c2w
    (mvimagenet.py:41-49)."""
    rot = matrix_from_quat(np.asarray(qvec, np.float64))
    c2w = np.eye(4)
    c2w[:3, :3] = rot.T
    c2w[:3, 3] = -rot.T @ np.asarray(tvec, np.float64)
    c2w[:, 1:3] *= -1
    return c2w.astype(np.float32)


class MVImageNet:
    """Scene-level loader producing V3D training items ((T,H,W,3) [-1,1])."""

    def __init__(self, root_dir: str, reso: int = 256,
                 num_frames: int = 24, mask_type: str = "random",
                 cond_aug_mean: float = -3.0, cond_aug_std: float = 0.5,
                 fps_id: float = 0.0, motion_bucket_id: float = 300.0,
                 load_pixelnerf: bool = False, scale_pose: bool = False,
                 max_n_cond: int = 1, min_n_cond: int = 1, seed: int = 0):
        self.root = root_dir
        self.reso = reso
        self.num_frames = num_frames
        self.mask_type = mask_type
        self.cond_aug_mean = cond_aug_mean
        self.cond_aug_std = cond_aug_std
        self.fps_id = fps_id
        self.motion_bucket_id = motion_bucket_id
        self.load_pixelnerf = load_pixelnerf
        self.scale_pose = scale_pose
        self.max_n_cond = max_n_cond
        self.min_n_cond = min_n_cond
        self.rng = np.random.RandomState(seed)
        self.ids = sorted(
            os.path.relpath(p, root_dir)
            for p in glob.glob(os.path.join(root_dir, "*", "*"))
            if os.path.isdir(p))
        if not self.ids:
            raise FileNotFoundError(f"no <class>/<scene> dirs under {root_dir}")

    def __len__(self) -> int:
        return len(self.ids)

    def _scene_dirs(self, index: int):
        image_dir = os.path.join(self.root, self.ids[index], "images")
        camera_dir = os.path.join(self.root, self.ids[index], "sparse", "0")
        if not os.path.isdir(camera_dir):       # mvimagenet.py:118-124
            image_dir = os.path.join(self.root, self.ids[0], "images")
            camera_dir = os.path.join(self.root, self.ids[0], "sparse", "0")
        return image_dir, camera_dir

    def _crop_box(self, frame, image_dir: str, name: str):
        w, h = frame.size
        size = min(h, w)
        if self.mask_type == "random":
            left = int(self.rng.randint(0, w - size + 1))
            top = int(self.rng.randint(0, h - size + 1))
        elif self.mask_type == "center":
            left, top = (w - size) // 2, (h - size) // 2
        elif self.mask_type == "rembg":
            # centered on the cached foreground matte when present
            # (mvimagenet.py:175-205); no matting network offline
            cached = os.path.join(image_dir,
                                  os.path.splitext(name)[0] + "_rembg.png")
            if os.path.exists(cached):
                from PIL import Image
                mask = np.asarray(Image.open(cached))[..., 3]
                ys, xs = np.nonzero(mask)
                cx = xs.mean() if len(xs) else w / 2
                cy = ys.mean() if len(ys) else h / 2
            else:
                cx, cy = w / 2, h / 2
            top = int(np.clip(cy - size / 2, 0, h - size))
            left = int(np.clip(cx - size / 2, 0, w - size))
        else:
            raise ValueError(self.mask_type)
        return left, top, size

    def __getitem__(self, index: int) -> Dict:
        from PIL import Image

        image_dir, camera_dir = self._scene_dirs(index)
        images_bin = read_images_binary(os.path.join(camera_dir, "images.bin"))
        keys = [k for k in images_bin
                if os.path.exists(os.path.join(image_dir, images_bin[k].name))]
        keys = sorted(keys, key=lambda k: images_bin[k].name)
        if not keys:
            return self[0] if index != 0 else self._raise_empty()
        # mirror-extend short scenes (mvimagenet.py:149-152)
        while len(keys) < self.num_frames:
            keys += list(reversed(keys[-(self.num_frames - len(keys)):]))

        intr = None
        if self.load_pixelnerf:
            cams = read_cameras_binary(os.path.join(camera_dir, "cameras.bin"))
            assert len(cams) == 1, "MVImageNet scenes are single-camera"
            intr = next(iter(cams.values()))

        frames, cameras = [], []
        for view_idx in range(self.num_frames):
            im = images_bin[keys[view_idx]]
            frame = Image.open(os.path.join(image_dir, im.name)).convert("RGB")
            left, top, size = self._crop_box(frame, image_dir, im.name)
            frame = frame.crop((left, top, left + size, top + size))
            frame = frame.resize((self.reso, self.reso), Image.BILINEAR)
            frames.append(np.asarray(frame, np.float32) / 127.5 - 1.0)
            if intr is not None:
                f, cx, cy = intr.params[0], intr.params[1], intr.params[2]
                K = np.array([[f / size, 0, (cx - left) / size],
                              [0, f / size, (cy - top) / size],
                              [0, 0, 1]], np.float32)
                cam = np.zeros(25, np.float32)
                cam[:16] = qt2c2w(im.qvec, im.tvec).reshape(-1)
                cam[16:] = K.reshape(-1)
                cameras.append(cam)

        t = self.num_frames
        frames = np.stack(frames).astype(np.float32)
        cond = frames[0]
        cond_aug = float(np.exp(
            self.rng.randn() * self.cond_aug_std + self.cond_aug_mean))
        data: Dict = {
            "frames": frames,
            "cond_frames_without_noise": cond,
            "cond_frames": cond + cond_aug * self.rng.randn(
                *cond.shape).astype(np.float32),
            "cond_aug": np.full((t,), cond_aug, np.float32),
            "fps_id": np.full((t,), self.fps_id, np.float32),
            "motion_bucket_id": np.full((t,), self.motion_bucket_id,
                                        np.float32),
            "num_video_frames": t,
            "image_only_indicator": np.zeros((t,), np.float32),
        }
        if self.load_pixelnerf:
            cams = np.stack(cameras)
            if self.scale_pose:
                cams = normalize_poses(cams)
            small = np.stack([
                np.asarray(Image.fromarray(
                    ((f + 1) * 127.5).astype(np.uint8)).resize(
                    (self.reso // 8, self.reso // 8), Image.BILINEAR),
                    np.float32) / 255.0
                for f in frames])
            data["pixelnerf_input"] = {"frames": frames, "cameras": cams,
                                       "rgb": small}
        return data

    def _raise_empty(self):
        raise RuntimeError("scene 0 has no readable frames")

    def collate_fn(self, items: Sequence[Dict]) -> Dict:
        if self.max_n_cond > 1:
            n_cond = int(self.rng.randint(self.min_n_cond,
                                          self.max_n_cond + 1))
            if n_cond > 1:
                for it in items:
                    src = [0] + self.rng.choice(
                        np.arange(1, self.num_frames), self.max_n_cond - 1,
                        replace=False).tolist()
                    pn = it["pixelnerf_input"]
                    pn["source_index"] = np.asarray(src, np.int32)
                    pn["n_cond"] = n_cond
                    pn["source_images"] = it["frames"][src]
                    pn["source_cameras"] = pn["cameras"][src]
        return video_collate(items)

    def iter_batches(self, batch_size: int) -> Iterator[Dict]:
        while True:
            idx = self.rng.randint(0, len(self), batch_size)
            yield self.collate_fn([self[int(i)] for i in idx])
