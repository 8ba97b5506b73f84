"""FLUX.1-dev at 1024^2 (``flux1-dev.json``): the port's
``ImageDiffusionEngine`` around its FLUX.1 transformer (``models/flux.py``)
and the 16-channel image decoder, filled with the seeded weights; the flow
denoiser (``FlowScaling``) and Euler over the shifted schedule, one row a
step (guidance-distilled: no CFG); and the plain reference
(``reference/flux.py``) with the same weights.

``tiny_cell`` cuts the cell to toy widths for the CPU tests (``tiny.py``
cuts the UNet configurations); never a benchmark cell.
"""

from __future__ import annotations

import copy

import torch

from portbench.bench import manifest
from portbench.bench.seeded import fill_seeded_, seed_for
from portbench.reference import flux as ref_flux, vae as ref_vae
from portbench.reference.numerics import F32, set_numerics

MODULES = ("transformer", "vae_decoder")

# the published keys cut to toy widths (a 32-channel decoder keeps its
# channel ratios)
TINY_TRANSFORMER = dict(num_attention_heads=2, attention_head_dim=64, axes_dims_rope=[16, 24, 24],
                        num_layers=2, num_single_layers=2, joint_attention_dim=64,
                        pooled_projection_dim=32)
TINY_VAE = dict(block_out_channels=[32, 64, 128, 128])
TINY_TEXT = dict(t5_tokens=7)
TINY_TRAFFIC = dict(resolution=64, num_steps=4)


def served_dtype(cfg: dict, use: str = "serve") -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["serve_dtype"]]


def net_kwargs(cfg: dict) -> dict:
    """``Flux``'s arguments from the published ``transformer/config.json``
    (``cfg["transformer"]``); the MLP ratio is 4 in BFL's and diffusers'
    code alike, no key of the config."""
    t = cfg["transformer"]
    if not t["guidance_embeds"] or t["patch_size"] != 1:
        raise ValueError("flux1-dev: the port's Flux is guidance-distilled on 2x2 patches")
    return dict(in_channels=t["in_channels"], vec_in_dim=t["pooled_projection_dim"],
                context_in_dim=t["joint_attention_dim"],
                hidden_size=t["num_attention_heads"] * t["attention_head_dim"],
                num_heads=t["num_attention_heads"], depth=t["num_layers"],
                depth_single_blocks=t["num_single_layers"], axes_dim=tuple(t["axes_dims_rope"]))


def decoder_kwargs(cfg: dict) -> dict:
    """The KL decoder's arguments from the published ``vae/config.json``
    (``cfg["vae"]``): diffusers' ``block_out_channels`` are ch x ch_mult and
    its ``layers_per_block`` the LDM's ``num_res_blocks`` (the decoder runs
    one more a level in both)."""
    v = cfg["vae"]
    ch = v["block_out_channels"][0]
    return dict(ch=ch, out_ch=v["out_channels"],
                ch_mult=tuple(c // ch for c in v["block_out_channels"]),
                num_res_blocks=v["layers_per_block"], z_channels=v["latent_channels"])


def image_tokens(cfg: dict, resolution: int) -> int:
    """The packed 2x2 patches of a ``resolution``^2 image's latent."""
    return (resolution // 8 // 2) ** 2


def build_port(cfg: dict, use: str, device, seed: int, sampler: dict = None):
    from v3d_tpu_torch import diffusion as D
    from v3d_tpu_torch.engines.image_diffusion import ImageDiffusionEngine
    from v3d_tpu_torch.models.flux import Flux
    from v3d_tpu_torch.models.vae import Decoder

    s = sampler or {}
    sch, vae = cfg["scheduler"], cfg["vae"]
    dtype = served_dtype(cfg, use)
    with torch.device("meta"):
        mods = {"transformer": Flux(**net_kwargs(cfg)),
                "vae_decoder": Decoder(**decoder_kwargs(cfg))}
    for name in MODULES:
        mods[name] = mods[name].to(dtype).to_empty(device=device).eval().requires_grad_(False)
        fill_seeded_(mods[name], seed_for(seed, "weights", name))
    schedule = D.ShiftedFlowDiscretization(
        image_tokens=image_tokens(cfg, s.get("resolution", cfg["resolution"])),
        base_shift=sch["base_shift"], max_shift=sch["max_shift"],
        base_tokens=sch["base_image_seq_len"], max_tokens=sch["max_image_seq_len"])
    return ImageDiffusionEngine(
        unet=mods["transformer"], denoiser=D.Denoiser(scaling=D.FlowScaling()),
        sampler=D.EulerEDMSampler(discretization=schedule, num_steps=s.get("num_steps", 28),
                                  guider=D.IdentityGuider()),
        vae_decoder=mods["vae_decoder"], scale_factor=vae["scaling_factor"],
        latent_channels=vae["latent_channels"], shift_factor=vae["shift_factor"])


def build_reference(cfg: dict, use: str, device, seed: int, numerics=F32,
                    modules=MODULES) -> ref_flux.FluxPipeline:
    """The reference in float32 on ``device`` (on "meta": shapes only), its
    weights the port's seeded values rounded to the served dtype."""
    makers = {"transformer": lambda: ref_flux.Flux(**net_kwargs(cfg)),
              "vae_decoder": lambda: ref_vae.Decoder(**decoder_kwargs(cfg))}
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
    return ref_flux.FluxPipeline(built["transformer"], built["vae_decoder"],
                                 cfg["vae"]["scaling_factor"], cfg["vae"]["shift_factor"])


def reference_sigmas(cfg: dict, num_steps: int, resolution: int):
    """The schedule, from the reference's own formula (n + 1 values)."""
    sch = cfg["scheduler"]
    return ref_flux.flux_sigmas(num_steps, image_tokens(cfg, resolution), sch["base_shift"],
                                sch["max_shift"], sch["base_image_seq_len"],
                                sch["max_image_seq_len"])


def tiny_cell(name: str = "flux1-dev.txt2img", dtype: str = "float32", bench: dict = None,
              pkg=manifest.PKG):
    """The cell at toy widths (hidden 128, 2 heads of 64, RoPE axes 16 /
    24 / 24, 2 + 2 blocks, a 64^2 image: an 8x8 latent, 16 patches; 7 text
    tokens; 4 steps), its weights in ``dtype``."""
    cell = manifest.load_cell(name, bench, pkg)
    cfg, traffic = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    cfg["transformer"].update(TINY_TRANSFORMER)
    cfg["vae"].update(TINY_VAE)
    cfg["text_encoders"].update(TINY_TEXT)
    cfg["serve_dtype"] = dtype
    traffic["params"].update(TINY_TRAFFIC)
    cell.config, cell.traffic = cfg, traffic
    return cell
