"""Experiment logging (counterpart of v3d_tpu/utils/logging.py; the
reference's CSV logger, train_from_vid.py:226-316).

``<log_dir>/metrics.csv``: its header from the first row; only int and
float fields are written.  ``log_images`` writes a PNG grid beside it.  The CSV is the only sink: TensorBoard's writer
imports TensorFlow where it is installed, and that can bring in jax, which
this package never loads.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, Optional


class ExperimentLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._csv_path = os.path.join(log_dir, "metrics.csv")
        self._csv_keys = None

    def log(self, metrics: Dict, step: Optional[int] = None) -> None:
        step = step if step is not None else int(time.time())
        row = {"step": step, **{k: v for k, v in metrics.items()
                                if isinstance(v, (int, float))}}
        write_header = self._csv_keys is None
        if write_header:
            self._csv_keys = list(row)
        with open(self._csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._csv_keys, extrasaction="ignore")
            if write_header:
                w.writeheader()
            w.writerow(row)

    def log_images(self, name: str, images, step: int) -> None:
        """``<log_dir>/<name>_<step:08d>.png``: the (T, H, W, C) frames in one
        row (the reference's recon grid, video_diffusion.py:276-291)."""
        from v3d_tpu_torch.data.video_io import save_image_grid

        save_image_grid(os.path.join(self.log_dir, f"{name}_{step:08d}.png"), images)
