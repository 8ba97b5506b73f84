"""V3D-512 (``v3d512.json``): the port's engine, built through its public
builder and filled with the seeded weights, and the plain reference with
the same weights.  ``use`` is "serve" (every module in the served dtype) or
"train" (float32 masters, the UNet computing in bf16 with its blocks
checkpointed, as ``apps.train_diffusion.build_train_engine`` builds it)."""

from __future__ import annotations

import torch

from portbench.bench.seeded import fill_seeded_, seed_for
from portbench.reference import clip as ref_clip
from portbench.reference import pipelines, unet as ref_unet, vae as ref_vae
from portbench.reference.numerics import F32, set_numerics

MODULES = ("unet", "vae_encoder", "vae_decoder", "clip")


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def served_dtype(cfg: dict, use: str) -> torch.dtype:
    return _dtype(cfg["serve_dtype"] if use == "serve" else cfg["train"]["param_dtype"])


def build_port(cfg: dict, use: str, device, seed: int, sampler: dict = None):
    """The port's ``VideoDiffusionEngine`` on ``device``."""
    from v3d_tpu_torch.engines.builder import build_v3d_engine

    fs = cfg["first_stage"]
    if (tuple(fs["ch_mult"]), fs["num_res_blocks"], fs["z_channels"]) != ((1, 2, 4, 4), 2, 4):
        raise ValueError("the port's builder makes the (1, 2, 4, 4) x 2, z 4 first stage only")
    net = dict(cfg["network"])
    mc = net.pop("model_channels")
    net = {k: tuple(v) if isinstance(v, list) else v for k, v in net.items()}
    if use == "train":
        net.update(compute_dtype=_dtype(cfg["train"]["compute_dtype"]),
                   use_checkpoint=cfg["train"]["use_checkpoint"])
    s = sampler or {}
    engine = build_v3d_engine(
        num_frames=cfg["num_frames"], num_steps=s.get("num_steps", 25),
        min_scale=s.get("min_cfg", 3.5), max_scale=s.get("max_cfg", 3.5),
        sigma_max=cfg["schedule"]["sigma_max"], model_channels=mc, vae_ch=fs["ch"],
        device="meta", dtype=served_dtype(cfg, use), clip_cfg=dict(cfg["clip"]),
        unet_overrides=net)
    for name in MODULES:
        mod = getattr(engine, name).to_empty(device=device)
        fill_seeded_(mod, seed_for(seed, "weights", name))
    return engine


def build_reference(cfg: dict, use: str, device, seed: int, numerics=F32,
                    modules=MODULES) -> pipelines.V3DPipeline:
    """The reference pipeline in float32 on ``device`` (on "meta": shapes
    only), its weights the port's: the same seeded values, rounded to the
    dtype the port holds them in.  ``modules`` limits what is built."""
    fs = cfg["first_stage"]
    net = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["network"].items()}
    makers = {
        "unet": lambda: ref_unet.VideoUNet(**net, use_checkpoint=use == "train"),
        "vae_encoder": lambda: ref_vae.Encoder(**fs),
        "vae_decoder": lambda: ref_vae.VideoDecoder(out_ch=3, **fs),
        "clip": lambda: ref_clip.CLIPVisionTransformer(**cfg["clip"]),
    }
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
    return pipelines.V3DPipeline(built["unet"], built["vae_encoder"], built["vae_decoder"],
                                 built["clip"], cfg["num_frames"], cfg["scale_factor"])
