"""Network wrapper (counterpart of v3d_tpu/engines/wrappers.py; sgm
wrappers.py:23-34): channel-concat the 'concat' cond onto x, 'crossattn' as
context, 'vector' as y.  The sampler works on channels-last latents; the
UNet takes NCHW, and channels_last memory makes the permutes free.

With a ``mesh`` the UNet forward is frame-parallel over its "data" axis
(``parallel/frames.py``), the counterpart of the JAX package's sampling
jitted on frame-sharded inputs (v3d_tpu/parallel/mesh.py:7-10).  On a
(data, model) mesh a UNet that ``parallel.tensor.tp_shard_`` cut runs each
rank's block of rows tensor-parallel over "model" as well (the UNet carries
that binding); rows are split and gathered over the "data" group only.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from v3d_tpu_torch.parallel.frames import frame_shard, gather_rows
from v3d_tpu_torch.parallel.mesh import DATA_AXIS, axis_size


def make_unet_network_fn(unet: torch.nn.Module, num_video_frames: int,
                         mesh=None, rows_local: bool = False) -> Callable:
    """network(x, c_noise, cond, image_only_indicator) for the Denoiser;
    x and the result are ((b t), h, w, c).

    ``mesh``: the frame-parallel forward.  x, c_noise and the batched cond
    keys hold every row of the batch (the sampler's state, the same on
    every rank); each rank runs the UNet on its block of the rows, and the
    blocks are gathered (one all_gather).  With ``rows_local`` they hold
    this rank's block already (a training step's frames, the batch the
    ranks' blocks together) and the result stays this rank's block."""

    def network(x, c_noise, cond: Dict, image_only_indicator=None):
        if "concat" in cond:
            x = torch.cat([x, cond["concat"].to(x.dtype)], dim=-1)
        context, y = cond.get("crossattn"), cond.get("vector")
        kw = {}
        if mesh is not None:
            ranks = axis_size(mesh, DATA_AXIS) if rows_local else 1
            frames = kw["frames"] = frame_shard(mesh, ranks * x.shape[0], num_video_frames)
            if not rows_local:
                x, c_noise = x[frames.block], c_noise[frames.block]
                context = None if context is None else context[frames.block]
                y = None if y is None else y[frames.block]
        out = unet(x.permute(0, 3, 1, 2), c_noise, context=context, y=y,
                   num_video_frames=num_video_frames,
                   image_only_indicator=image_only_indicator, **kw)
        out = out.permute(0, 2, 3, 1)
        if mesh is not None and not rows_local:
            out = gather_rows(out.contiguous(), kw["frames"])
        return out

    return network
