"""The cells at toy widths, for the CPU tests: the same configuration and
traffic files with their widths, sizes and step counts cut, run on the
CPU.  Never a benchmark cell."""

from __future__ import annotations

import copy

from portbench.bench import manifest

TINY_NET = dict(model_channels=32, num_res_blocks=1, attention_resolutions=[2, 1],
                channel_mult=[1, 2], num_head_channels=16, context_dim=64)
TINY_CLIP = dict(width=64, layers=2, heads=4, patch_size=16, image_size=224, output_dim=64)
TINY_TRAFFIC = dict(image_size=64, resolution=64, num_steps=4, decoding_t=2, batch=2,
                    videos=2, latent_hw=8)


def tiny_cell(name: str, dtype: str = "bfloat16", bench: dict = None, pkg=manifest.PKG):
    """The cell ``name`` cut to toy size; its weights (and the training
    compute) in ``dtype``."""
    cell = manifest.load_cell(name, bench, pkg)
    cfg, traffic = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    cfg["network"].update(TINY_NET)
    cfg["first_stage"]["ch"] = 32
    cfg["serve_dtype"] = dtype
    if "train" in cfg:
        cfg["train"]["compute_dtype"] = dtype
    if "clip" in cfg:
        cfg["clip"] = dict(TINY_CLIP)
        cfg["num_frames"] = 4
    if "text_encoder" in cfg:
        cfg["text_encoder"] = {"context_tokens": 7, "context_dim": 64}
    params = traffic["params"]
    for k, v in TINY_TRAFFIC.items():
        if k in params:
            params[k] = v
    cell.config, cell.traffic = cfg, traffic
    return cell
