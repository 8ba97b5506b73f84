"""One training step replayed from a CUDA graph (the trainers' step chunks:
``GSTrainer.train_chunk``, ``NeusTrainer.train_chunk``).

The first ``warmup`` calls run the step eagerly on a side stream (lazy
initialisation, such as an optimizer's state or a library's handle, may
not happen inside a capture); the next call captures it and every call
from then on replays it.  The step must do device work only, read its
inputs from tensors the caller writes in place before each call, and
return the same output tensors each time; a failed capture or replay
raises.  A capture launches nothing, so the kernel launches it counted in
``LAUNCHES`` are taken back and each replay adds them.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch

from v3d_tpu_torch.ops._dispatch import LAUNCHES


class StepGraph:
    def __init__(self, device: torch.device, warmup: int = 3):
        self.device = device
        self.warmup = warmup
        self.warm = 0
        self.graph = None
        self.out = None       # the captured step's outputs
        self.launches: Dict[str, int] = {}
        self.capture_s = 0.0  # host seconds of the capture (instantiation included)

    def __call__(self, step: Callable):
        """Run ``step()`` once (eagerly, or as a replay) and return its
        outputs: a replay returns the captured output tensors, which the
        next call overwrites."""
        if self.graph is None and self.warm < self.warmup:
            side = torch.cuda.Stream(self.device)
            main = torch.cuda.current_stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                out = step()
            main.wait_stream(side)
            self.warm += 1
            return out
        if self.graph is None:
            before = dict(LAUNCHES)
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.out = step()
            self.capture_s = time.perf_counter() - t0
            self.launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                             if LAUNCHES[k] != before[k]}
            LAUNCHES.update(before)
            self.graph = graph
        self.graph.replay()
        for k, v in self.launches.items():
            LAUNCHES[k] += v
        return self.out
