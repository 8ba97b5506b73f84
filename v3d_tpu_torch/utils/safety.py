"""NSFW / watermark detection filter and the invisible watermark
(counterpart of v3d_tpu/utils/safety.py; scripts/util/detection/
nsfw_and_watermark_dectection.py:39-110, sgm/inference/helpers.py:16-60).

CLIP ViT-L/14 image features (the port's ``CLIPVisionTransformer`` with
``VIT_L_CONFIG``) go through two linear heads (p_head_v1.npz /
w_head_v1.npz, from ``$V3D_TPU_SAFETY_HEADS``); flagged frames are blurred
with OpenCV's 31-tap Gaussian, computed here (``_blur``).  Without the heads
or a CLIP model the filter passes frames through, and says so.  The
watermark is the dwtDct (imwatermark EmbedMaxDct) scheme in float64 numpy.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

VIT_L_CONFIG = dict(width=1024, layers=24, heads=16, patch_size=14,
                    image_size=224, output_dim=768)


def _load_head(path: str) -> Optional[Dict[str, np.ndarray]]:
    if not os.path.exists(path):
        return None
    return dict(np.load(path))


def _run_head(head: Dict[str, np.ndarray], feats: np.ndarray) -> np.ndarray:
    """The v1 heads are linear probes on CLIP features: keys 'weights'
    (768,) and 'biases' (scalar); else an MLP of ordered w* / b* arrays."""
    if "weights" in head:
        logits = feats @ head["weights"].reshape(-1) + float(head["biases"])
        return 1.0 / (1.0 + np.exp(-logits))
    x = feats
    keys = sorted(k for k in head if k.startswith("w"))
    for i, wk in enumerate(keys):
        bk = "b" + wk[1:]
        x = x @ head[wk]
        if bk in head:
            x = x + head[bk]
        if i < len(keys) - 1:
            x = np.maximum(x, 0)
    return 1.0 / (1.0 + np.exp(-x.reshape(len(feats))))


class DeepFloydDataFiltering:
    """``clip``: a ``CLIPVisionTransformer`` with ViT-L/14's geometry (its
    device runs the features), or None."""

    def __init__(self, verbose: bool = False, head_dir: Optional[str] = None,
                 clip: Optional[torch.nn.Module] = None):
        head_dir = head_dir or os.environ.get("V3D_TPU_SAFETY_HEADS", "")
        self.p_head = _load_head(os.path.join(head_dir, "p_head_v1.npz")) if head_dir else None
        self.w_head = _load_head(os.path.join(head_dir, "w_head_v1.npz")) if head_dir else None
        self.clip = clip
        self.verbose = verbose
        self.thresholds = {"p": 0.5, "w": 0.5}
        if self.p_head is None or self.clip is None:
            print("safety filter: heads/CLIP weights unavailable — "
                  "pass-through mode")

    @torch.no_grad()
    def features(self, images: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) float in [0, 1] -> the CLIP features (N, 768),
        float32, unit norm."""
        from v3d_tpu_torch.models.clip_vit import clip_preprocess

        dev = next(self.clip.parameters()).device
        x = torch.as_tensor(np.asarray(images, np.float32), device=dev) * 2 - 1
        feats = self.clip(clip_preprocess(x).permute(0, 3, 1, 2)).float().cpu().numpy()
        return feats / np.linalg.norm(feats, axis=-1, keepdims=True)

    def flags(self, images: np.ndarray) -> np.ndarray:
        feats = self.features(images)
        flags = _run_head(self.p_head, feats) > self.thresholds["p"]
        if self.w_head is not None:
            flags |= _run_head(self.w_head, feats) > self.thresholds["w"]
        return flags

    def __call__(self, images: np.ndarray) -> np.ndarray:
        """images (N, H, W, 3) float in [0, 1]; flagged frames are blurred
        (nsfw_and_watermark_dectection.py:57-76)."""
        if self.p_head is None or self.clip is None:
            return images
        flags = self.flags(images)
        if flags.any():
            images = images.copy()
            images[flags] = _blur(images[flags])
            if self.verbose:
                print(f"safety filter: blurred {int(flags.sum())} frames")
        return images


def _gaussian_taps(k: int) -> np.ndarray:
    """cv2.getGaussianKernel(k, 0): sigma = 0.3 ((k - 1) / 2 - 1) + 0.8."""
    sigma = 0.3 * ((k - 1) * 0.5 - 1) + 0.8
    x = np.arange(k, dtype=np.float64) - (k - 1) / 2
    w = np.exp(-x * x / (2 * sigma * sigma))
    return w / w.sum()


def _blur(imgs: np.ndarray, k: int = 31) -> np.ndarray:
    """``cv2.GaussianBlur(im, (k, k), 0)`` per image: the separable k-tap
    Gaussian with OpenCV's default border BORDER_REFLECT_101 (scipy's
    "mirror"), in float64, cast back to the images' dtype."""
    from scipy.ndimage import correlate1d

    w = _gaussian_taps(k)
    out = []
    for im in np.asarray(imgs):
        x = im.astype(np.float64)
        for axis in (0, 1):
            x = correlate1d(x, w, axis=axis, mode="mirror")
        out.append(x.astype(im.dtype))
    return np.stack(out)


# The fixed 48-bit message of sgm/inference/helpers.py:53-57 (MSB first).
WATERMARK_MESSAGE = 0b101100111110110010010000011110111011000110011110
WATERMARK_BITS = [int(b) for b in bin(WATERMARK_MESSAGE)[2:]]

# cv2's documented BGR <-> YUV (PAL) constants, which imwatermark runs through
_YUV_FWD = np.array([  # rows: Y, U, V; columns: B, G, R
    [0.114, 0.587, 0.299],
    [0.492 * (1 - 0.114), 0.492 * -0.587, 0.492 * -0.299],
    [0.877 * -0.114, 0.877 * -0.587, 0.877 * (1 - 0.299)],
], np.float64)


def _haar_dwt2(x: np.ndarray):
    """pywt.dwt2(x, 'haar') for even-sized x: cA / cH / cV / cD at half res."""
    a, b = x[0::2, 0::2], x[0::2, 1::2]
    c, d = x[1::2, 0::2], x[1::2, 1::2]
    return ((a + b + c + d) / 2, (a + b - c - d) / 2,
            (a - b + c - d) / 2, (a - b - c + d) / 2)


def _haar_idwt2(ca, ch, cv, cd):
    h2, w2 = ca.shape
    out = np.empty((h2 * 2, w2 * 2), np.float64)
    out[0::2, 0::2] = (ca + ch + cv + cd) / 2
    out[0::2, 1::2] = (ca + ch - cv - cd) / 2
    out[1::2, 0::2] = (ca - ch + cv - cd) / 2
    out[1::2, 1::2] = (ca - ch - cv + cd) / 2
    return out


def _ll_blocks(channel: np.ndarray, block: int = 4):
    """The DWT LL plane cut into (N, block * block) flat blocks, and what
    reassembles it."""
    ca, ch, cv, cd = _haar_dwt2(channel)
    h2, w2 = ca.shape
    nr, nc = h2 // block, w2 // block
    blocks = (ca[:nr * block, :nc * block]
              .reshape(nr, block, nc, block).transpose(0, 2, 1, 3)
              .reshape(nr * nc, block * block))
    return blocks, (ca, ch, cv, cd), (nr, nc, block)


def _put_blocks(blocks, planes, geom):
    ca, ch, cv, cd = planes
    nr, nc, block = geom
    ca = ca.copy()
    ca[:nr * block, :nc * block] = (
        blocks.reshape(nr, nc, block, block).transpose(0, 2, 1, 3)
        .reshape(nr * block, nc * block))
    return _haar_idwt2(ca, ch, cv, cd)


def _max_nondc_pos(blocks: np.ndarray) -> np.ndarray:
    """imwatermark EmbedMaxDct: per block, the index of the largest |coef|
    after the DC (flat index 0)."""
    return np.argmax(np.abs(blocks[:, 1:]), axis=1) + 1


def embed_watermark(images: np.ndarray, bits=None, scale: float = 36.0) -> np.ndarray:
    """dwtDct invisible watermark (imwatermark 'dwtDct', scales [0, 36, 0],
    block 4): images (N, H, W, 3) RGB in [0, 1].  Each 4x4 block of the U
    channel's Haar-LL plane has its strongest non-DC coefficient quantised
    to (|v| // s + 0.25 + 0.5 bit) s."""
    bits = np.asarray(WATERMARK_BITS if bits is None else bits, np.float64)
    out = np.empty_like(images)
    for n in range(images.shape[0]):
        rgb = np.asarray(images[n], np.float64) * 255.0
        h, w = rgb.shape[:2]
        hh, ww = h // 4 * 4, w // 4 * 4
        bgr = rgb[..., ::-1]
        yuv = bgr @ _YUV_FWD.T
        yuv[..., 1:] += 128.0
        u = yuv[:hh, :ww, 1]
        blocks, planes, geom = _ll_blocks(u)
        pos = _max_nondc_pos(blocks)
        idx = np.arange(blocks.shape[0])
        val = blocks[idx, pos]
        bit = bits[idx % len(bits)]
        q = (np.abs(val) // scale + 0.25 + 0.5 * bit) * scale
        blocks[idx, pos] = np.where(val >= 0, q, -q)
        yuv[:hh, :ww, 1] = _put_blocks(blocks, planes, geom)
        yuv[..., 1:] -= 128.0
        bgr = yuv @ np.linalg.inv(_YUV_FWD).T
        out[n] = np.clip(bgr[..., ::-1] / 255.0, 0.0, 1.0)
    return out


def extract_watermark(images: np.ndarray, num_bits: int = 48,
                      scale: float = 36.0) -> np.ndarray:
    """imwatermark WatermarkDecoder('bits') for dwtDct: a majority vote of
    (|v| mod s) > s / 2 over each bit's blocks.  images (N, H, W, 3) RGB in
    [0, 1]; returns (num_bits,) booleans."""
    votes = np.zeros(num_bits)
    counts = np.zeros(num_bits)
    for n in range(images.shape[0]):
        rgb = np.asarray(images[n], np.float64) * 255.0
        h, w = rgb.shape[:2]
        hh, ww = h // 4 * 4, w // 4 * 4
        bgr = rgb[..., ::-1]
        yuv = bgr @ _YUV_FWD.T
        yuv[..., 1:] += 128.0
        blocks, _, _ = _ll_blocks(yuv[:hh, :ww, 1])
        pos = _max_nondc_pos(blocks)
        idx = np.arange(blocks.shape[0])
        val = np.abs(blocks[idx, pos])
        score = (val % scale) > 0.5 * scale
        np.add.at(votes, idx % num_bits, score)
        np.add.at(counts, idx % num_bits, 1.0)
    return (votes / np.maximum(counts, 1)) > 0.5
