"""Video IO through OpenCV (a port of the JAX package's ``data/video_io.py``,
the replacement for mediapy / imageio-ffmpeg at scripts/pub/V3D_512.py:306
and recon/train_from_vid.py:367-370): mp4v at 3 fps, RGB uint8 frames.

cv2 is imported inside the functions; without it they raise an
ImportError that names it.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("video IO needs OpenCV (the cv2 module), which is not "
                          "installed") from e
    return cv2


def _uint8(frames) -> np.ndarray:
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = np.clip(frames * 255, 0, 255).astype(np.uint8)
    return frames


def write_video(path: str, frames: np.ndarray, fps: int = 3) -> None:
    """frames: (T, H, W, 3) uint8 RGB, or float in [0, 1]."""
    cv2 = _cv2()
    frames = _uint8(frames)
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    try:
        for f in frames:
            writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    finally:
        writer.release()


def read_video(path: str) -> np.ndarray:
    """-> (T, H, W, 3) uint8 RGB."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    frames: List[np.ndarray] = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    finally:
        cap.release()
    if not frames:
        raise IOError(f"no frames read from {path}")
    return np.stack(frames)


def save_image_grid(path: str, frames: np.ndarray, cols: Optional[int] = None) -> None:
    """The frames tiled row by row into one PNG (sgm/util.py
    video_frames_as_grid)."""
    from PIL import Image

    frames = _uint8(frames)
    t, h, w, c = frames.shape
    cols = cols or t
    rows = -(-t // cols)
    grid = np.zeros((rows * h, cols * w, c), np.uint8)
    for i, f in enumerate(frames):
        r, cc = divmod(i, cols)
        grid[r * h:(r + 1) * h, cc * w:(cc + 1) * w] = f
    Image.fromarray(grid).save(path)
