"""Depth colormaps (counterpart of v3d_tpu/utils/colormaps.py, a copy
kept here so that the port imports nothing of the JAX package; itself of
recon/utils/colormaps.py apply_depth_colormap :127-158, with matplotlib
replaced by the published turbo polynomial fit).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# Google's turbo colormap polynomial approximation (public): per-channel
# degree-5 polynomials in the normalized value
_TURBO_R = np.array([0.13572138, 4.61539260, -42.66032258, 132.13108234,
                     -152.94239396, 59.28637943])
_TURBO_G = np.array([0.09140261, 2.19418839, 4.84296658, -14.18503333,
                     4.27729857, 2.82956604])
_TURBO_B = np.array([0.10667330, 12.64194608, -60.58204836, 110.36276771,
                     -89.90310912, 27.34824973])


def _poly(c: np.ndarray, x: np.ndarray) -> np.ndarray:
    y = np.zeros_like(x)
    for i, k in enumerate(c):
        y = y + k * x ** i
    return y


def turbo(x: np.ndarray) -> np.ndarray:
    """x in [0,1] -> (..., 3) rgb in [0,1]."""
    x = np.clip(np.asarray(x, np.float64), 0.0, 1.0)
    rgb = np.stack([_poly(_TURBO_R, x), _poly(_TURBO_G, x),
                    _poly(_TURBO_B, x)], axis=-1)
    return np.clip(rgb, 0.0, 1.0).astype(np.float32)


def gray(x: np.ndarray) -> np.ndarray:
    x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
    return np.repeat(x[..., None], 3, axis=-1)


_CMAPS = {"turbo": turbo, "default": turbo, "gray": gray}


def apply_depth_colormap(depth: np.ndarray,
                         accumulation: Optional[np.ndarray] = None,
                         near_plane: Optional[float] = None,
                         far_plane: Optional[float] = None,
                         colormap: str = "turbo") -> np.ndarray:
    """(H, W) depth -> (H, W, 3) rgb (colormaps.py:127-158 semantics:
    near/far normalization, colormap, composite over white by
    accumulation)."""
    near = near_plane if near_plane is not None else float(depth.min())
    far = far_plane if far_plane is not None else float(depth.max())
    d = np.clip((depth - near) / max(far - near, 1e-10), 0.0, 1.0)
    colored = _CMAPS[colormap](d)
    if accumulation is not None:
        a = np.asarray(accumulation, np.float32)[..., None]
        colored = colored * a + (1.0 - a)
    return colored
