"""Orbit-video training data (counterpart of v3d_tpu/data/objaverse.py; sgm
data/objaverse.py).

A training item holds the target views (``latents``, (T, h, w, 4) already
VAE-encoded and scaled, or ``frames``, (T, H, W, 3) pixels in [-1, 1]), the
front view's CLIP embedding or its pixels (``cond_frames_without_noise``),
the front view plus cond-aug noise (``cond_frames``), and per-frame fps /
motion bucket / cond aug.  ``video_collate`` flattens frame fields (b, t,
...) -> (b*t, ...) and stacks per-video fields.  Items are numpy arrays; the
trainer encodes pixels on the way in (``apps.train_diffusion.prepare_batch``)
and moves batches to the device.

``OrbitRenderDataset`` reads ``<object>/latents.npy`` (T, h, w, 4) where it
exists, else the rendered orbit ``<object>/*.png``, each with an optional
``<object>/clip_emb.npy`` (1, d).  ``SyntheticOrbitDataset`` makes seeded
latent orbits and, with ``clip_dim``, a seeded embedding per object in place
of the clip_emb.npy file: the JAX package's synthetic items carry the latent
front view there, which its CLI then sends through CLIP and fails on
(ROADMAP Queue C, C3).
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, Iterator, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class OrbitItemConfig:
    num_frames: int = 18
    cond_aug: float = 0.02
    fps_id: float = 1.0
    motion_bucket_id: float = 300.0
    # front-view selection (objaverse.py:236-282): "first" | "random"
    frontview: str = "first"


def assemble_item(frames_or_latents: np.ndarray, cfg: OrbitItemConfig,
                  rng: np.random.RandomState,
                  clip_emb: Optional[np.ndarray] = None,
                  is_latent: bool = False) -> Dict:
    """One training example from (T, H, W, C) views (objaverse.py:44-66)."""
    t = cfg.num_frames
    data = frames_or_latents[:t]
    if cfg.frontview == "random":
        front_idx = int(rng.randint(len(data)))
        data = np.roll(data, -front_idx, axis=0)
    cond = data[0]
    cond_noisy = cond + cfg.cond_aug * rng.randn(*cond.shape).astype(cond.dtype)
    return {
        ("latents" if is_latent else "frames"): data,
        "cond_frames_without_noise": cond if clip_emb is None else clip_emb,
        "cond_frames": cond_noisy,
        "fps_id": np.full((t,), cfg.fps_id, np.float32),
        "motion_bucket_id": np.full((t,), cfg.motion_bucket_id, np.float32),
        "cond_aug": np.full((t,), cfg.cond_aug, np.float32),
        "image_only_indicator": np.zeros((t,), np.float32),
        "num_video_frames": t,
    }


# fields flattened (b, t, ...) -> (b*t, ...) by the collate (objaverse.py:71)
_FRAME_FIELDS = ("frames", "latents", "fps_id", "motion_bucket_id",
                 "cond_aug", "image_only_indicator", "elevation")


def _collate_default(vals):
    if isinstance(vals[0], dict):
        return {k: _collate_default([v[k] for v in vals]) for k in vals[0]}
    if isinstance(vals[0], str):
        return list(vals)
    return np.stack(vals)


def video_collate(items: Sequence[Dict]) -> Dict:
    """objaverse.py:83-103 (video_collate_fn): frame fields flatten, per-video
    fields stack; nested dicts (``pixelnerf_input``) stack recursively, with
    their ``rgb`` flattened (b, t, ...) -> (b*t, ...)."""
    out: Dict = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if key == "num_video_frames":
            out[key] = vals[0]
        elif key in _FRAME_FIELDS:
            stacked = np.stack(vals)
            out[key] = stacked.reshape((-1,) + stacked.shape[2:])
        else:
            out[key] = _collate_default(vals)
    if "image_only_indicator" in out:
        out["image_only_indicator"] = out["image_only_indicator"].reshape(
            -1, out["num_video_frames"])
    if "pixelnerf_input" in out:
        rgb = out["pixelnerf_input"]["rgb"]
        out["pixelnerf_input"]["rgb"] = rgb.reshape((-1,) + rgb.shape[2:])
    return out


def _decode_orbit(pngs: Sequence[str]) -> np.ndarray:
    """An orbit's frames -> (t, h, w, 3) float32 in [0, 255] (objaverse.py
    :106-120): the native threaded decoder (``native.imgdec``) first, PIL
    where it is unavailable or an item fails; RGB, the alpha of RGBA renders
    dropped, not composited."""
    from PIL import Image

    from v3d_tpu_torch.native.imgdec import decode_batch, decode_image

    first = decode_image(pngs[0])
    if first is not None:
        out = decode_batch(pngs, first.shape[:2])
        if out is not None and out[1].all():
            return out[0][..., :3].astype(np.float32)
    return np.stack([np.asarray(Image.open(p).convert("RGB"), np.float32)
                     for p in pngs])


class OrbitRenderDataset:
    """Directory of objects (objaverse.py:123-166):

        <root>/<object>/000.png ... 0TT.png   the rendered orbit
        <root>/<object>/latents.npy           optional, (T, h, w, 4) pre-encoded
        <root>/<object>/clip_emb.npy          optional, (1, d)

    GObjaverse's latents256 / clip_emb256 shortcut (objaverse.py:328-351)
    where latents.npy exists, else the PNG frames in [-1, 1]; an item that
    cannot be read (a missing or truncated file, frames of unequal size)
    falls back to item 0 (objaverse.py:294-306)."""

    def __init__(self, root: str, cfg: OrbitItemConfig = OrbitItemConfig(),
                 seed: int = 0):
        self.root = root
        self.cfg = cfg
        self.rng = np.random.RandomState(seed)
        self.objects = sorted(
            d for d in glob.glob(os.path.join(root, "*")) if os.path.isdir(d))
        if not self.objects:
            raise FileNotFoundError(f"no object dirs under {root}")

    def __len__(self) -> int:
        return len(self.objects)

    def _load(self, idx: int) -> Dict:
        obj = self.objects[idx]
        lat_path = os.path.join(obj, "latents.npy")
        clip_path = os.path.join(obj, "clip_emb.npy")
        clip_emb = (np.load(clip_path).astype(np.float32)
                    if os.path.exists(clip_path) else None)
        if os.path.exists(lat_path):
            lat = np.load(lat_path).astype(np.float32)
            return assemble_item(lat, self.cfg, self.rng, clip_emb, is_latent=True)
        frames = _decode_orbit(sorted(glob.glob(os.path.join(obj, "*.png"))))
        return assemble_item((frames / 127.5 - 1.0).astype(np.float32), self.cfg,
                             self.rng, clip_emb)

    def __getitem__(self, idx: int) -> Dict:
        try:
            return self._load(idx)
        except (OSError, ValueError, EOFError):
            return self._load(0)

    def iter_batches(self, batch_size: int, shuffle: bool = True) -> Iterator[Dict]:
        order = np.arange(len(self))
        while True:
            if shuffle:
                self.rng.shuffle(order)
            for s in range(0, len(order) - batch_size + 1, batch_size):
                yield video_collate([self[int(i)] for i in order[s:s + batch_size]])


class SyntheticOrbitDataset:
    """Seeded latent orbits for tests and train-throughput runs (the same
    draws as the JAX package's); with ``clip_dim``, also a seeded (1,
    clip_dim) embedding per object from a second generator."""

    def __init__(self, num_objects: int = 8, num_frames: int = 18,
                 latent_hw: int = 64, cfg: Optional[OrbitItemConfig] = None,
                 seed: int = 0, clip_dim: Optional[int] = None):
        self.cfg = cfg or OrbitItemConfig(num_frames=num_frames)
        self.rng = np.random.RandomState(seed)
        self.latents = self.rng.randn(
            num_objects, num_frames, latent_hw, latent_hw, 4).astype(np.float32)
        self.clip_embs = None if clip_dim is None else (
            np.random.RandomState(seed + 1)
            .randn(num_objects, 1, clip_dim).astype(np.float32))

    def __len__(self) -> int:
        return len(self.latents)

    def __getitem__(self, idx: int) -> Dict:
        emb = None if self.clip_embs is None else self.clip_embs[idx]
        return assemble_item(self.latents[idx], self.cfg, self.rng, emb,
                             is_latent=True)

    def iter_batches(self, batch_size: int) -> Iterator[Dict]:
        n = len(self)
        while True:
            idx = self.rng.randint(0, n, batch_size)
            yield video_collate([self[int(i)] for i in idx])
