"""Checkpoint key maps: each torch state-dict key of the VideoUNet, the VAE
encoder / image decoder / temporal decoder, the CLIP vision tower, the DPT
normal predictor and the PixelNeRF ResUNet -> (Flax param path, transform of
the torch tensor into the Flax leaf).

A copy of the key maps of the JAX package's ``core/convert.py`` (:25-409,
:436-537, ``convert_resunet`` :540-589), kept here so that the port imports
nothing of that package.  The entry points are ``convert_unet_key``,
``convert_unet2d_key`` (the image UNet, whose map the JAX package lacks:
it takes the Flax tree's own names), ``convert_vae_key``,
``convert_clip_key``, ``convert_dpt_key`` and ``convert_resunet_key``; each
returns None for a key it does not know.
``convert_discriminator_key`` and ``convert_pixelnerf_key`` map modules that
have no published checkpoint and take the JAX tree's own names.

- Linear:  torch (out, in)            -> flax kernel (in, out)      [transpose]
- Conv2d:  torch (O, I, kh, kw)       -> flax kernel (kh, kw, I, O)
- Conv3d:  torch (O, I, kt, kh, kw)   -> flax kernel (kt, kh, kw, I, O)
- GroupNorm/LayerNorm: weight -> scale
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np


def t2j(t) -> np.ndarray:
    """torch tensor -> numpy (f32)."""
    return np.asarray(t.detach().cpu().float().numpy())


def linear_w(t):
    return t2j(t).T


def conv2_w(t):
    return t2j(t).transpose(2, 3, 1, 0)


def conv3_w(t):
    return t2j(t).transpose(2, 3, 4, 1, 0)


# ---------------------------------------------------------------------------
# sub-module translators: given the remainder of a torch key, return
# (flax subpath, transform) or None
# ---------------------------------------------------------------------------

def _norm_path(name: str, kind: str, param: str) -> Tuple[str, ...]:
    inner = "GroupNorm_0" if kind == "gn" else "LayerNorm_0"
    leaf = {"weight": "scale", "bias": "bias"}[param]
    return (name, inner, leaf)


def _map_linear(name: str, param: str):
    if param == "weight":
        return (name, "kernel"), linear_w
    return (name, "bias"), t2j


def _map_conv(name: str, param: str, dims: int = 2):
    if param == "weight":
        return (name, "kernel"), conv2_w if dims == 2 else conv3_w
    return (name, "bias"), t2j


def _map_plain_resblock(rest: str, prefix: Tuple[str, ...], dims: int = 2):
    """torch ResBlock (openaimodel.py:220) -> flax models.layers.ResBlock."""
    m = re.match(r"in_layers\.0\.(weight|bias)$", rest)
    if m:
        return prefix + _norm_path("in_norm", "gn", m.group(1)), t2j
    m = re.match(r"in_layers\.2\.(weight|bias)$", rest)
    if m:
        p, f = _map_conv("in_conv", m.group(1), dims)
        return prefix + p, f
    m = re.match(r"emb_layers\.1\.(weight|bias)$", rest)
    if m:
        p, f = _map_linear("emb_linear", m.group(1))
        return prefix + p, f
    m = re.match(r"out_layers\.0\.(weight|bias)$", rest)
    if m:
        return prefix + _norm_path("out_norm", "gn", m.group(1)), t2j
    m = re.match(r"out_layers\.3\.(weight|bias)$", rest)
    if m:
        p, f = _map_conv("out_conv", m.group(1), dims)
        return prefix + p, f
    m = re.match(r"skip_connection\.(weight|bias)$", rest)
    if m:
        p, f = _map_conv("skip_conv", m.group(1), dims)
        return prefix + p, f
    return None


def _map_video_resblock(rest: str, prefix: Tuple[str, ...]):
    """video_model.py VideoResBlock: spatial ResBlock fields live at the top
    level, temporal ones under time_stack., plus time_mixer.mix_factor."""
    if rest == "time_mixer.mix_factor":
        return prefix + ("time_mixer", "mix_factor"), t2j
    if rest.startswith("time_stack."):
        return _map_plain_resblock(rest[len("time_stack."):],
                                   prefix + ("time_stack",), dims=3)
    return _map_plain_resblock(rest, prefix + ("spatial",), dims=2)


def _map_cross_attention(rest: str, prefix: Tuple[str, ...]):
    m = re.match(r"to_(q|k|v)\.weight$", rest)
    if m:
        return prefix + (f"to_{m.group(1)}", "kernel"), linear_w
    m = re.match(r"to_out\.0\.(weight|bias)$", rest)
    if m:
        p, f = _map_linear("to_out", m.group(1))
        return prefix + p, f
    return None


def _map_feedforward(rest: str, prefix: Tuple[str, ...]):
    m = re.match(r"net\.0\.proj\.(weight|bias)$", rest)
    if m:
        p, f = _map_linear("proj", m.group(1))
        return prefix + ("net_0",) + p, f
    m = re.match(r"net\.2\.(weight|bias)$", rest)
    if m:
        p, f = _map_linear("net_2", m.group(1))
        return prefix + p, f
    return None


def _map_transformer_block(rest: str, prefix: Tuple[str, ...]):
    """BasicTransformerBlock / VideoTransformerBlock fields."""
    for attn in ("attn1", "attn2"):
        if rest.startswith(attn + "."):
            return _map_cross_attention(rest[len(attn) + 1:], prefix + (attn,))
    for norm in ("norm_in", "norm1", "norm2", "norm3"):
        m = re.match(norm + r"\.(weight|bias)$", rest)
        if m:
            return prefix + _norm_path(norm, "ln", m.group(1)), t2j
    if rest.startswith("ff_in."):
        return _map_feedforward(rest[len("ff_in."):], prefix + ("ff_in",))
    if rest.startswith("ff."):
        return _map_feedforward(rest[len("ff."):], prefix + ("ff",))
    return None


def _map_spatial_video_transformer(rest: str, prefix: Tuple[str, ...]):
    m = re.match(r"norm\.(weight|bias)$", rest)
    if m:
        return prefix + _norm_path("norm", "gn", m.group(1)), t2j
    m = re.match(r"proj_(in|out)\.(weight|bias)$", rest)
    if m:
        p, f = _map_linear(f"proj_{m.group(1)}", m.group(2))
        return prefix + p, f
    m = re.match(r"time_pos_embed\.(0|2)\.(weight|bias)$", rest)
    if m:
        p, f = _map_linear(f"time_pos_embed_{m.group(1)}", m.group(2))
        return prefix + p, f
    if rest == "time_mixer.mix_factor":
        return prefix + ("time_mixer", "mix_factor"), t2j
    m = re.match(r"transformer_blocks\.(\d+)\.(.*)$", rest)
    if m:
        return _map_transformer_block(m.group(2), prefix + (f"blocks_{m.group(1)}",))
    m = re.match(r"time_stack\.(\d+)\.(.*)$", rest)
    if m:
        return _map_transformer_block(m.group(2), prefix + (f"time_stack_{m.group(1)}",))
    return None


def _map_unet_layer(rest: str, prefix: Tuple[str, ...], block_map=None):
    """Translate one layer inside a TimestepEmbedSequential; ``block_map``
    maps the attention and res blocks (default: the VideoUNet's)."""
    # Downsample / Upsample
    m = re.match(r"op\.(weight|bias)$", rest)
    if m:
        p, f = _map_conv("op", m.group(1))
        return prefix + p, f
    m = re.match(r"conv\.(weight|bias)$", rest)
    if m:
        p, f = _map_conv("conv", m.group(1))
        return prefix + p, f
    # plain conv (input_blocks.0.0)
    m = re.match(r"(weight|bias)$", rest)
    if m:
        p, f = _map_conv(prefix[-1], m.group(1))
        return prefix[:-1] + p, f
    if block_map is not None:
        return block_map(rest, prefix)
    out = _map_spatial_video_transformer(rest, prefix)
    if out is not None:
        return out
    return _map_video_resblock(rest, prefix)


def convert_unet_key(key: str, block_map=None):
    m = re.match(r"time_embed\.(0|2)\.(weight|bias)$", key)
    if m:
        return _map_linear(f"time_embed_{m.group(1)}", m.group(2))
    m = re.match(r"label_emb\.0\.(0|2)\.(weight|bias)$", key)
    if m:
        return _map_linear(f"label_emb_{m.group(1)}", m.group(2))
    m = re.match(r"out\.0\.(weight|bias)$", key)
    if m:
        return _norm_path("out_norm", "gn", m.group(1)), t2j
    m = re.match(r"out\.2\.(weight|bias)$", key)
    if m:
        return _map_conv("out_conv", m.group(1))
    m = re.match(r"input_blocks\.(\d+)\.(\d+)\.(.*)$", key)
    if m:
        return _map_unet_layer(m.group(3), (f"in_{m.group(1)}_{m.group(2)}",), block_map)
    m = re.match(r"middle_block\.(\d+)\.(.*)$", key)
    if m:
        return _map_unet_layer(m.group(2), (f"mid_{m.group(1)}",), block_map)
    m = re.match(r"output_blocks\.(\d+)\.(\d+)\.(.*)$", key)
    if m:
        return _map_unet_layer(m.group(3), (f"out_{m.group(1)}_{m.group(2)}",), block_map)
    return None


# ---------------------------------------------------------------------------
# the image UNet (v3d_tpu/models/unet2d.py).  The JAX package has no
# converter for it (its convert_video_unet sends every res block through
# the video map); this map takes the Flax tree's own names: in_{b}_{l},
# mid_{l}, out_{b}_{l}, blocks_{i}, in_norm / in_conv / emb_linear /
# out_norm / out_conv / skip_conv.
# ---------------------------------------------------------------------------

def _map_spatial_transformer(rest: str, prefix: Tuple[str, ...], use_linear: bool):
    """attention_blocks.SpatialTransformer: proj_in / proj_out are Dense
    layers or, without ``use_linear``, 1x1 convolutions."""
    m = re.match(r"norm\.(weight|bias)$", rest)
    if m:
        return prefix + _norm_path("norm", "gn", m.group(1)), t2j
    m = re.match(r"proj_(in|out)\.(weight|bias)$", rest)
    if m:
        mapper = _map_linear if use_linear else _map_conv
        p, f = mapper(f"proj_{m.group(1)}", m.group(2))
        return prefix + p, f
    m = re.match(r"transformer_blocks\.(\d+)\.(.*)$", rest)
    if m:
        return _map_transformer_block(m.group(2), prefix + (f"blocks_{m.group(1)}",))
    return None


def convert_unet2d_key(key: str, use_linear: bool = True):
    def block_map(rest, prefix):
        out = _map_spatial_transformer(rest, prefix, use_linear)
        return out if out is not None else _map_plain_resblock(rest, prefix)

    return convert_unet_key(key, block_map)


# ---------------------------------------------------------------------------
# VAE converters (sgm/modules/diffusionmodules/model.py + temporal_ae.py)
# ---------------------------------------------------------------------------

def conv1x1_to_dense(t):
    w = t2j(t)  # (O, I, 1, 1)
    return w[:, :, 0, 0].T


def _map_vae_resnet(rest: str, prefix: Tuple[str, ...], video: bool):
    """ResnetBlock (model.py:144) fields; in VideoResBlockAE (temporal_ae.py)
    the spatial fields live under our 'spatial' submodule and temporal ones
    under 'time_stack'."""
    if video:
        if rest == "mix_factor":
            return prefix + ("mix_factor",), t2j
        if rest.startswith("time_stack."):
            return _map_plain_resblock(rest[len("time_stack."):],
                                       prefix + ("time_stack",), dims=3)
        prefix = prefix + ("spatial",)
    for norm in ("norm1", "norm2"):
        m = re.match(norm + r"\.(weight|bias)$", rest)
        if m:
            return prefix + _norm_path(norm, "gn", m.group(1)), t2j
    for conv in ("conv1", "conv2", "conv_shortcut"):
        m = re.match(conv + r"\.(weight|bias)$", rest)
        if m:
            p, f = _map_conv(conv, m.group(1))
            return prefix + p, f
    m = re.match(r"nin_shortcut\.(weight|bias)$", rest)
    if m:
        p, f = _map_conv("nin_shortcut", m.group(1))
        return prefix + p, f
    return None


def _map_vae_attn(rest: str, prefix: Tuple[str, ...]):
    m = re.match(r"norm\.(weight|bias)$", rest)
    if m:
        return prefix + _norm_path("norm", "gn", m.group(1)), t2j
    m = re.match(r"(q|k|v|proj_out)\.(weight|bias)$", rest)
    if m:
        name, param = m.group(1), m.group(2)
        if param == "weight":
            return prefix + (name, "kernel"), conv1x1_to_dense
        return prefix + (name, "bias"), t2j
    return None


def convert_vae_key(key: str, video_decoder: bool):
    m = re.match(r"conv_in\.(weight|bias)$", key)
    if m:
        return _map_conv("conv_in", m.group(1))
    m = re.match(r"norm_out\.(weight|bias)$", key)
    if m:
        return _norm_path("norm_out", "gn", m.group(1)), t2j
    m = re.match(r"conv_out\.(weight|bias)$", key)
    if m:
        p, f = _map_conv("conv", m.group(1))
        return (("conv_out",) + p, f) if video_decoder else _map_conv("conv_out", m.group(1))
    m = re.match(r"conv_out\.time_mix_conv\.(weight|bias)$", key)
    if m:
        p, f = _map_conv("time_mix_conv", m.group(1), dims=3)
        return ("conv_out",) + p, f
    m = re.match(r"(down|up)\.(\d+)\.block\.(\d+)\.(.*)$", key)
    if m:
        d, i, j, rest = m.groups()
        return _map_vae_resnet(rest, (f"{d}_{i}_block_{j}",),
                               video=video_decoder)
    m = re.match(r"(down|up)\.(\d+)\.attn\.(\d+)\.(.*)$", key)
    if m:
        d, i, j, rest = m.groups()
        return _map_vae_attn(rest, (f"{d}_{i}_attn_{j}",))
    m = re.match(r"down\.(\d+)\.downsample\.conv\.(weight|bias)$", key)
    if m:
        p, f = _map_conv("conv", m.group(2))
        return (f"down_{m.group(1)}_downsample",) + p, f
    m = re.match(r"up\.(\d+)\.upsample\.conv\.(weight|bias)$", key)
    if m:
        p, f = _map_conv("conv", m.group(2))
        return (f"up_{m.group(1)}_upsample",) + p, f
    m = re.match(r"mid\.(block_1|block_2)\.(.*)$", key)
    if m:
        return _map_vae_resnet(m.group(2), (f"mid_{m.group(1)}",),
                               video=video_decoder)
    m = re.match(r"mid\.attn_1\.(.*)$", key)
    if m:
        return _map_vae_attn(m.group(1), ("mid_attn_1",))
    return None


# ---------------------------------------------------------------------------
# CLIP visual tower converter (open_clip VisionTransformer state dict, keys
# as they appear inside FrozenOpenCLIPImageEmbedder: "model.visual.*")
# ---------------------------------------------------------------------------


def convert_clip_key(k: str):
    if k == "conv1.weight":
        return ("conv1", "kernel"), conv2_w
    if k == "class_embedding":
        return ("class_embedding",), t2j
    if k == "positional_embedding":
        return ("positional_embedding",), t2j
    if k == "proj":
        return ("proj",), t2j  # stored as (width, out) already
    for ln in ("ln_pre", "ln_post"):
        m = re.match(ln + r"\.(weight|bias)$", k)
        if m:
            return _norm_path(ln, "ln", m.group(1)), t2j
    m = re.match(r"transformer\.resblocks\.(\d+)\.(.*)$", k)
    if m:
        i, rest = m.groups()
        prefix = (f"resblocks_{i}",)
        for ln in ("ln_1", "ln_2"):
            mm = re.match(ln + r"\.(weight|bias)$", rest)
            if mm:
                return prefix + _norm_path(ln, "ln", mm.group(1)), t2j
        if rest == "attn.in_proj_weight":
            return prefix + ("attn", "in_proj", "kernel"), linear_w
        if rest == "attn.in_proj_bias":
            return prefix + ("attn", "in_proj", "bias"), t2j
        mm = re.match(r"attn\.out_proj\.(weight|bias)$", rest)
        if mm:
            p, f = _map_linear("out_proj", mm.group(1))
            return prefix + ("attn",) + p, f
        mm = re.match(r"mlp\.(c_fc|c_proj)\.(weight|bias)$", rest)
        if mm:
            p, f = _map_linear(mm.group(1), mm.group(2))
            return prefix + p, f
    return None


# ---------------------------------------------------------------------------
# DPT (Omnidata normal predictor, mesh_recon/utils/dpt.py DPTDepthModel with
# the vitb_rn50_384 backbone): omnidata_dpt_normal_v2.ckpt's keys, with the
# Lightning "model." prefix stripped or not
# ---------------------------------------------------------------------------

# keys the forward never reads: the ViT's final LayerNorm (the hooks fire
# before it, convert.py:457-458) and refinenet4's first residual unit (the
# deepest fusion block has no skip input)
DPT_UNUSED = re.compile(r"(model\.)?(pretrained\.model\.norm\.|"
                        r"scratch\.refinenet4\.resConfUnit1\.)")


def _dpt_gn(prefix: Tuple[str, ...], param: str) -> Tuple[str, ...]:
    return prefix + ("GroupNorm_0", {"weight": "scale", "bias": "bias"}[param])


def _map_dpt_backbone(rest, pre: Tuple[str, ...]):
    """pretrained.model.* (timm vit_base_resnet50_384) after the prefix."""
    if rest[0] in ("cls_token", "pos_embed") and len(rest) == 1:
        return pre + (rest[0],), t2j
    if rest[0] == "patch_embed" and rest[1] == "proj":
        p, f = _map_conv("patch_proj", rest[2])
        return pre + p, f
    if rest[:2] == ["patch_embed", "backbone"]:
        bb = pre + ("backbone",)
        if rest[2] == "stem":
            if rest[3] == "conv":
                return bb + ("stem_conv", "kernel"), conv2_w
            return _dpt_gn(bb + ("stem_norm",), rest[4]), t2j
        if rest[2] == "stages" and rest[4] == "blocks":
            blk = bb + (f"stage{rest[3]}_block{rest[5]}",)
            name = rest[6]
            if name.startswith("conv"):
                return blk + (name, "kernel"), conv2_w
            if name.startswith("norm"):
                return _dpt_gn(blk + (name,), rest[7]), t2j
            if name == "downsample" and rest[7] == "conv":
                return blk + ("down_conv", "kernel"), conv2_w
            if name == "downsample" and rest[7] == "norm":
                return _dpt_gn(blk + ("down_norm",), rest[8]), t2j
        return None
    if rest[0] == "blocks":
        blk = pre + (f"vit_block{rest[1]}",)
        name = rest[2]
        if name in ("norm1", "norm2"):
            return blk + (name, {"weight": "scale", "bias": "bias"}[rest[3]]), t2j
        if name == "attn":
            p, f = _map_linear({"qkv": "qkv", "proj": "attn_proj"}[rest[3]], rest[4])
            return blk + p, f
        if name == "mlp":
            p, f = _map_linear(rest[3], rest[4])
            return blk + p, f
    return None


def convert_dpt_key(key: str):
    """A DPTDepthModel key -> (Flax path in models.dpt.DPT's tree,
    transform) as ``convert_dpt`` maps it; None for the unused final norm
    and for a key it does not know."""
    if key.startswith("model."):
        key = key[6:]
    parts = key.split(".")
    if key.startswith("pretrained.model.norm."):
        return None
    if key.startswith("pretrained.model."):
        return _map_dpt_backbone(parts[2:], ("pretrained",))
    m = re.match(r"pretrained\.act_postprocess([34])\.(\d+)\.(.*)$", key)
    if m:
        n, i, rest = m.groups()
        if i == "0":   # ProjectReadout: .project.0 is the Linear
            mm = re.match(r"project\.0\.(weight|bias)$", rest)
            p, f = _map_linear(f"readout{n}_proj", mm.group(1)) if mm else (None, None)
        elif i == "3":   # 1x1 conv
            p, f = _map_conv(f"post{n}_conv", rest)
        elif i == "4" and n == "4":   # 3x3 stride-2 conv
            p, f = _map_conv("post4_down", rest)
        else:
            return None
        return (("pretrained",) + p, f) if p else None
    m = re.match(r"scratch\.(layer[1-4]_rn)\.weight$", key)
    if m:
        return (m.group(1), "kernel"), conv2_w
    m = re.match(r"scratch\.(refinenet[1-4])\.out_conv\.(weight|bias)$", key)
    if m:
        p, f = _map_conv("out_conv", m.group(2))
        return (m.group(1),) + p, f
    m = re.match(r"scratch\.(refinenet[1-4])\.resConfUnit([12])\.(conv[12])\."
                 r"(weight|bias)$", key)
    if m:
        p, f = _map_conv(m.group(3), m.group(4))
        return (m.group(1), "rcu" + m.group(2)) + p, f
    m = re.match(r"scratch\.output_conv\.([024])\.(weight|bias)$", key)
    if m:
        head = {"0": "head_conv1", "2": "head_conv2", "4": "head_conv3"}[m.group(1)]
        return _map_conv(head, m.group(2))
    return None


# ---------------------------------------------------------------------------
# PixelNeRF ResUNet (sgm/modules/encoders/image_encoder.py:200-349 names),
# the discriminator and PixelNeRF (the JAX tree's names)
# ---------------------------------------------------------------------------

_BN_LEAF = {"weight": "scale", "bias": "bias"}


def convert_resunet_key(key: str):
    """A ResUNet key -> (path in models.pixelnerf_encoder.ResUNet's tree,
    transform), as ``convert_resunet`` maps it (BatchNorm without running
    statistics: only its affine scale and bias)."""
    m = re.match(r"conv1\.weight$", key)
    if m:
        return ("conv1", "kernel"), conv2_w
    m = re.match(r"bn1\.(weight|bias)$", key)
    if m:
        return ("bn1", _BN_LEAF[m.group(1)]), t2j
    m = re.match(r"layer(\d)\.(\d+)\.(.*)$", key)
    if m:
        li, bi, rest = m.groups()
        blk = (f"layer{li}_block{bi}",)
        mm = re.match(r"(conv[12])\.weight$", rest)
        if mm:
            return blk + (mm.group(1), "kernel"), conv2_w
        mm = re.match(r"(bn[12])\.(weight|bias)$", rest)
        if mm:
            return blk + (mm.group(1), _BN_LEAF[mm.group(2)]), t2j
        if rest == "downsample.0.weight":
            return blk + ("down_conv", "kernel"), conv2_w
        mm = re.match(r"downsample\.1\.(weight|bias)$", rest)
        if mm:
            return blk + ("down_bn", _BN_LEAF[mm.group(1)]), t2j
        return None
    m = re.match(r"(upconv[23])\.conv\.(conv|bn)\.(weight|bias)$", key) or \
        re.match(r"(iconv[23])\.(conv|bn)\.(weight|bias)$", key)
    if m:
        name, sub, param = m.groups()
        if sub == "conv":
            p, f = _map_conv("conv", param)
            return (name,) + p, f
        return (name, "bn", _BN_LEAF[param]), t2j
    m = re.match(r"out_conv\.(weight|bias)$", key)
    if m:
        return _map_conv("out_conv", m.group(1))
    return None


def convert_discriminator_key(key: str):
    """An NLayerDiscriminator key -> its path in the JAX tree (the port
    names its modules as the tree does)."""
    m = re.match(r"(conv_in|conv_\d+|conv_out)\.(weight|bias)$", key)
    if m:
        return _map_conv(m.group(1), m.group(2))
    m = re.match(r"(GroupNorm_\d+)\.(weight|bias)$", key)
    if m:
        return (m.group(1), _BN_LEAF[m.group(2)]), t2j
    return None


def convert_pixelnerf_key(key: str):
    """A PixelNeRF key -> its path in the JAX tree: the heads and the
    small UNet by their own names, the ResUNet encoder by its checkpoint
    names under ``encoder``."""
    m = re.match(r"(mlp1|mlp2|density_head|rgb_head)\.(weight|bias)$", key)
    if m:
        return _map_linear(m.group(1), m.group(2))
    m = re.match(r"encoder\.(enc[123]|dec[12])\.(weight|bias)$", key)
    if m:
        p, f = _map_conv(m.group(1), m.group(2))
        return ("encoder",) + p, f
    if key.startswith("encoder."):
        mapped = convert_resunet_key(key[len("encoder."):])
        return None if mapped is None else (("encoder",) + mapped[0], mapped[1])
    return None
