"""SD 2.1 v at 768^2 (``sd21-v768.json``): the port's
``ImageDiffusionEngine`` (UNet2D and the image decoder, filled with the
seeded weights; the discrete v-denoiser; Euler with vanilla CFG) and the
plain reference with the same weights."""

from __future__ import annotations

import torch

from portbench.bench.seeded import fill_seeded_, seed_for
from portbench.reference import pipelines, unet as ref_unet, vae as ref_vae
from portbench.reference.numerics import F32, set_numerics

MODULES = ("unet", "vae_decoder")


def served_dtype(cfg: dict, use: str = "serve") -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["serve_dtype"]]


def _net(cfg):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["network"].items()}


def build_port(cfg: dict, use: str, device, seed: int, sampler: dict = None):
    from v3d_tpu_torch import diffusion as D
    from v3d_tpu_torch.engines.image_diffusion import ImageDiffusionEngine
    from v3d_tpu_torch.models.unet2d import UNetModel
    from v3d_tpu_torch.models.vae import Decoder

    s = sampler or {}
    dtype = served_dtype(cfg, use)
    with torch.device("meta"):
        mods = {"unet": UNetModel(**_net(cfg)), "vae_decoder": Decoder(out_ch=3, **cfg["first_stage"])}
    for name in MODULES:
        mods[name] = mods[name].to(dtype).to_empty(device=device).eval().requires_grad_(False)
        fill_seeded_(mods[name], seed_for(seed, "weights", name))
    return ImageDiffusionEngine(
        unet=mods["unet"],
        denoiser=D.DiscreteDenoiser(scaling=D.VScaling(),
                                    discretization=D.LegacyDDPMDiscretization()),
        sampler=D.EulerEDMSampler(discretization=D.LegacyDDPMDiscretization(),
                                  num_steps=s.get("num_steps", 50),
                                  guider=D.VanillaCFG(s.get("cfg", 5.0))),
        vae_decoder=mods["vae_decoder"], scale_factor=cfg["scale_factor"])


def build_reference(cfg: dict, use: str, device, seed: int, numerics=F32,
                    modules=MODULES) -> pipelines.ImagePipeline:
    makers = {"unet": lambda: ref_unet.UNetModel(**_net(cfg)),
              "vae_decoder": lambda: ref_vae.Decoder(out_ch=3, **cfg["first_stage"])}
    built = {}
    for name in MODULES:
        if name not in modules:
            built[name] = None
            continue
        with torch.device("meta"):
            mod = makers[name]()
        if torch.device(device).type != "meta":
            mod = mod.to_empty(device=device)
            fill_seeded_(mod, seed_for(seed, "weights", name), served_dtype(cfg, use))
        built[name] = set_numerics(mod, numerics)
    return pipelines.ImagePipeline(built["unet"], built["vae_decoder"], cfg["scale_factor"])
