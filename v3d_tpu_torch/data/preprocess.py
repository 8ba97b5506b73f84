"""Input-image preprocessing (counterpart of v3d_tpu/data/preprocess.py;
scripts/pub/V3D_512.py:200-227): matte -> recenter with a border margin
(kiui.op.recenter) -> composite on white -> resize -> [-1, 1].

Pure numpy, without cv2: the resizes use the index sampling the JAX module
falls back to when cv2 is absent (preprocess.py:46-51, 111-117).  Matting
uses the image's own alpha, or ``luminance_matte``; a learned matting model
comes with a later slice.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def _index_resize(x: np.ndarray, h: int, w: int) -> np.ndarray:
    yi = np.linspace(0, x.shape[0] - 1, h).astype(int)
    xi = np.linspace(0, x.shape[1] - 1, w).astype(int)
    return x[yi][:, xi]


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
    resized = _index_resize(image[x_min:x_max, y_min:y_max], h2, w2)
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
    return _index_resize(imf, resolution, resolution) * 2.0 - 1.0
