"""Network wrapper (counterpart of v3d_tpu/engines/wrappers.py; sgm
wrappers.py:23-34): channel-concat the 'concat' cond onto x, 'crossattn' as
context, 'vector' as y.  The sampler works on channels-last latents; the
UNet takes NCHW, and channels_last memory makes the permutes free.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def make_unet_network_fn(unet: torch.nn.Module, num_video_frames: int) -> Callable:
    """network(x, c_noise, cond, image_only_indicator) for the Denoiser;
    x and the result are ((b t), h, w, c)."""

    def network(x, c_noise, cond: Dict, image_only_indicator=None):
        if "concat" in cond:
            x = torch.cat([x, cond["concat"].to(x.dtype)], dim=-1)
        out = unet(x.permute(0, 3, 1, 2), c_noise,
                   context=cond.get("crossattn"), y=cond.get("vector"),
                   num_video_frames=num_video_frames,
                   image_only_indicator=image_only_indicator)
        return out.permute(0, 2, 3, 1)

    return network
