"""Input-image preprocessing (counterpart of v3d_tpu/data/preprocess.py;
scripts/pub/V3D_512.py:200-227): matte -> recenter with a border margin
(kiui.op.recenter) -> composite on white -> resize -> [-1, 1].

Pure numpy, without cv2, computing what the JAX module computes with cv2
(preprocess.py:46-47, :111-113): ``area_resize`` is ``cv2.INTER_AREA`` on
the uint8 crop of ``recenter``, ``linear_resize`` is ``cv2.INTER_LINEAR``
on the float32 image.  Matting uses the image's own alpha, or
``luminance_matte``; a learned matting model comes with a later slice.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np


def _area_taps(n_in: int, n_out: int, average: bool
               ) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's INTER_AREA taps along one axis: (n_out, k) source indices
    and weights (zero-padded).  Where both axes shrink (``average``) each
    output averages its source interval [i s, (i + 1) s) with fractional
    end weights (``computeResizeAreaTab``); otherwise it interpolates
    between floor(i s) and the next pixel with OpenCV's area fraction, the
    last pixel replicated.  s = 1 / (n_out / n_in) in double and the
    fraction rounded to float, as OpenCV computes them."""
    inv = n_out / n_in
    scale = 1.0 / inv
    if average:
        rows = []
        for i in range(n_out):
            f1 = i * scale
            f2 = f1 + scale
            cell = min(scale, n_in - f1)
            s1, s2 = int(np.ceil(f1)), int(np.floor(f2))
            s2 = min(s2, n_in - 1)
            s1 = min(s1, s2)
            taps = []
            if s1 - f1 > 1e-3:
                taps.append((s1 - 1, (s1 - f1) / cell))
            taps += [(s, 1.0 / cell) for s in range(s1, s2)]
            if f2 - s2 > 1e-3:
                taps.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
            rows.append(taps)
        k = max(len(r) for r in rows)
        idx = np.zeros((n_out, k), np.int64)
        wts = np.zeros((n_out, k), np.float64)
        for i, taps in enumerate(rows):
            for j, (s, w) in enumerate(taps):
                idx[i, j], wts[i, j] = s, w
        return idx, wts
    d = np.arange(n_out)
    sx = np.floor(d * scale).astype(np.int64)
    fx = ((d + 1) - (sx + 1) * inv).astype(np.float32).astype(np.float64)
    fx = np.where(fx <= 0, 0.0, fx - np.floor(fx))
    fx = np.where(sx >= n_in - 1, 0.0, fx)
    return (np.stack([sx, np.minimum(sx + 1, n_in - 1)], 1),
            np.stack([1 - fx, fx], 1))


def _linear_taps(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's INTER_LINEAR taps along one axis: half-pixel centres, edge
    pixels replicated."""
    x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    sx = np.floor(x).astype(np.int64)
    fx = x - sx
    low, high = sx < 0, sx >= n_in - 1
    fx = np.where(low | high, 0.0, fx)
    sx = np.clip(sx, 0, n_in - 1)
    return np.stack([sx, np.minimum(sx + 1, n_in - 1)], 1), np.stack([1 - fx, fx], 1)


def _apply_taps(x: np.ndarray, axis: int, taps) -> np.ndarray:
    idx, wts = taps
    shape = (-1,) + (1,) * (x.ndim - axis - 1)
    out = 0.0
    for j in range(idx.shape[1]):
        out = out + np.take(x, idx[:, j], axis=axis) * wts[:, j].reshape(shape)
    return out


def area_resize(x: np.ndarray, h: int, w: int) -> np.ndarray:
    """``cv2.resize(x, (w, h), interpolation=cv2.INTER_AREA)`` on uint8
    (H, W[, C]): the sums in float64, rounded half to even and saturated
    as ``saturate_cast<uchar>``."""
    src = x.astype(np.float64)
    average = x.shape[0] >= h and x.shape[1] >= w
    y = _apply_taps(_apply_taps(src, 1, _area_taps(x.shape[1], w, average)), 0,
                    _area_taps(x.shape[0], h, average))
    return np.clip(np.rint(y), 0, 255).astype(np.uint8)


def linear_resize(x: np.ndarray, h: int, w: int) -> np.ndarray:
    """``cv2.resize(x, (w, h), interpolation=cv2.INTER_LINEAR)`` on float32
    (H, W[, C])."""
    src = x.astype(np.float64)
    y = _apply_taps(_apply_taps(src, 1, _linear_taps(x.shape[1], w)), 0,
                    _linear_taps(x.shape[0], h))
    return y.astype(np.float32)


def recenter(image: np.ndarray, mask: np.ndarray,
             border_ratio: float = 0.2) -> np.ndarray:
    """Crop to the mask's bounding box and paste it centred into a square
    canvas with a ``border_ratio`` margin."""
    H, W = image.shape[:2]
    C = 1 if image.ndim == 2 else image.shape[2]
    size = max(H, W)
    result = np.zeros((size, size, C), dtype=image.dtype)
    coords = np.nonzero(mask)
    if len(coords[0]) == 0:
        return image
    x_min, x_max = coords[0].min(), coords[0].max()
    y_min, y_max = coords[1].min(), coords[1].max()
    h, w = x_max - x_min, y_max - y_min
    if h == 0 or w == 0:
        return image
    desired = int(size * (1 - border_ratio))
    scale = desired / max(h, w)
    h2, w2 = int(h * scale), int(w * scale)
    x2 = (size - h2) // 2
    y2 = (size - w2) // 2
    resized = area_resize(image[x_min:x_max, y_min:y_max], h2, w2)
    result[x2:x2 + h2, y2:y2 + w2] = resized.reshape(h2, w2, C)
    return result


def luminance_matte(image: np.ndarray, threshold: int = 250) -> np.ndarray:
    """Near-white pixels become background.  RGB uint8 -> RGBA uint8."""
    rgb = image[..., :3]
    alpha = np.where(np.all(rgb >= threshold, axis=-1), 0, 255).astype(np.uint8)
    return np.concatenate([rgb.astype(np.uint8), alpha[..., None]], axis=-1)


def preprocess_image(image: np.ndarray, border_ratio: float = 0.3,
                     resolution: int = 512,
                     remove_bg: Optional[Callable] = None,
                     ignore_alpha: bool = False) -> np.ndarray:
    """(H, W, 3|4) uint8 -> (resolution, resolution, 3) float32 in [-1, 1]."""
    image = np.asarray(image)
    if border_ratio > 0:
        if image.shape[-1] != 4 or ignore_alpha:
            rgba = (remove_bg or luminance_matte)(image[..., :3])
        else:
            rgba = image
        image = recenter(rgba, rgba[..., -1] > 0, border_ratio=border_ratio)
        imf = image.astype(np.float32) / 255.0
        if imf.shape[-1] == 4:
            imf = imf[..., :3] * imf[..., 3:4] + (1 - imf[..., 3:4])
    else:
        imf = image[..., :3].astype(np.float32) / 255.0
    return linear_resize(imf, resolution, resolution) * 2.0 - 1.0
