"""Declarative engine construction from YAML (counterpart of
v3d_tpu/engines/from_config.py; sgm.util.instantiate_from_config over the
registry):

    engine = engine_from_config(load_config("configs/v3d_512.yaml"))

The engine is the one ``engines/builder.build_v3d_engine`` makes, with the
config's values where they differ (the YAML's sampler runs 30 steps): the
same modules and parameter names, built on the meta device and filled by
the same seeded init, so checkpoints load into it unchanged.
"""

from __future__ import annotations

from typing import Mapping

import torch

# populate the registry
import v3d_tpu_torch.diffusion  # noqa: F401
import v3d_tpu_torch.diffusion.loss  # noqa: F401
import v3d_tpu_torch.engines.lr_schedule  # noqa: F401
import v3d_tpu_torch.models.regularizers  # noqa: F401
import v3d_tpu_torch.models.unet2d  # noqa: F401
from v3d_tpu_torch.core.registry import instantiate
from v3d_tpu_torch.engines.builder import materialise
from v3d_tpu_torch.engines.video_diffusion import VideoDiffusionEngine
from v3d_tpu_torch.models.clip_vit import CLIPVisionTransformer
from v3d_tpu_torch.models.conditioner import EmbedderSpec, GeneralConditioner


def conditioner_from_config(emb_cfgs) -> GeneralConditioner:
    specs = []
    for cfg in emb_cfgs:
        emb = instantiate({"target": cfg["target"],
                           "params": cfg.get("params", {})})
        specs.append(EmbedderSpec(
            embed=emb, input_key=cfg["input_key"],
            ucg_rate=float(cfg.get("ucg_rate", 0.0)),
            is_trainable=bool(cfg.get("is_trainable", False))))
    return GeneralConditioner(embedders=tuple(specs))


def engine_from_config(cfg: Mapping, dtype: torch.dtype = torch.bfloat16,
                       device="cuda") -> VideoDiffusionEngine:
    """The engine of ``cfg["model"]`` with seeded weights in ``dtype`` on
    ``device`` (the card unless the caller passes another; "meta" builds
    the modules without storage).  The UNet, encoder, decoder and CLIP take
    the seeds 0..3, as ``build_v3d_engine`` gives them at its default seed;
    the config names no CLIP, which is the builder's ViT-H/14."""
    m = cfg["model"]
    with torch.device("meta"):
        unet = instantiate(m["network"])
        encoder = instantiate(m["first_stage"]["encoder"])
        decoder = instantiate(m["first_stage"]["decoder"])
        clip = CLIPVisionTransformer()
    mods = [materialise(mod, device, dtype, i)
            for i, mod in enumerate((unet, encoder, decoder, clip))]
    engine = VideoDiffusionEngine(
        unet=mods[0], denoiser=instantiate(m["denoiser"]),
        sampler=instantiate(m["sampler"]), vae_encoder=mods[1],
        vae_decoder=mods[2], clip=mods[3],
        scale_factor=float(m.get("scale_factor", 0.18215)),
        num_frames=int(m.get("num_frames", 18)),
        loss_fn=instantiate(m["loss"]) if "loss" in m else None)
    # the configured embedders replace the default conditioner
    if "conditioner_embedders" in m:
        cond = conditioner_from_config(m["conditioner_embedders"])
        engine.conditioner = lambda: cond
    return engine
