"""LPIPS perceptual distance (counterpart of v3d_tpu/metrics/lpips.py; the
vendored sgm modules/autoencoding/lpips and recon/lpipsPyTorch).

VGG16 features at relu1_2 / 2_2 / 3_3 / 4_3 / 5_3, each unit-normalised
over its channels, squared difference, learned non-negative 1x1 heads,
spatial mean, summed over the taps.  The weights are the JAX package's
.npz layout (``conv{i}_w`` HWIO, ``conv{i}_b``, ``lin{i}``), so one file
drives both packages; ``convert_lpips_torch`` writes it from a torch LPIPS
state dict.  No weights ship with the repository: ``load_lpips`` returns
None when the file is absent, as the JAX function does.

The normalisation keeps the JAX form ``a / sqrt(sum a^2 + 1e-10)`` (eps
inside the root; the ``lpips`` package adds it outside): its gradient stays
finite where a ReLU tap is all zero, as on an orbit render's flat
background.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from v3d_tpu_torch.utils.precision import conv2d_f32

# VGG16's conv plan (output channels; "M" a 2x2 max pool) and the conv
# indices (0-based among the convs) whose ReLU outputs are the taps
VGG_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512]
TAPS = (1, 3, 6, 9, 12)
SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
SCALE = np.array([0.458, 0.448, 0.450], np.float32)
DEFAULT_WEIGHTS = Path(__file__).resolve().parents[2] / "weights" / "lpips_vgg.npz"


@functools.lru_cache(maxsize=None)
def _input_norm(device: torch.device):
    """SHIFT and SCALE on ``device``, made once (a step captured in a CUDA
    graph reads them and may not copy them from the host)."""
    return (torch.as_tensor(SHIFT, device=device), torch.as_tensor(SCALE, device=device))


def vgg_features(params: Dict[str, torch.Tensor], x: torch.Tensor) -> List[torch.Tensor]:
    """x (N, H, W, 3) in [-1, 1] -> the tap activations, NCHW.  3x3 convs
    with SAME padding (1), 2x2 max pools VALID (odd sizes floor).  The
    convolutions and their gradients run in full float32 whatever the
    caller's TF32 setting (``utils.precision.conv2d_f32``)."""
    shift, scale = _input_norm(x.device)
    h = ((x - shift) / scale).permute(0, 3, 1, 2)
    feats, conv_i = [], 0
    for spec in VGG_PLAN:
        if spec == "M":
            h = F.max_pool2d(h, 2, 2)
            continue
        h = F.relu(conv2d_f32(h, params[f"conv{conv_i}_w"], params[f"conv{conv_i}_b"],
                              padding=1))
        if conv_i in TAPS:
            feats.append(h)
        conv_i += 1
    return feats


def lpips_distance(params: Dict[str, torch.Tensor], x: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """x, y (N, H, W, 3) in [0, 1] -> (N,) perceptual distances."""
    n = x.shape[0]
    feats = vgg_features(params, torch.cat([x, y]) * 2 - 1)
    total = 0.0
    for i, f in enumerate(feats):
        f = f / torch.sqrt(torch.sum(f * f, dim=1, keepdim=True) + 1e-10)
        d = (f[:n] - f[n:]) ** 2
        lin = params[f"lin{i}"]  # (C,) weights of the 1x1 head
        total = total + torch.sum(d * lin[:, None, None], dim=1).mean(dim=(1, 2))
    return total


def lpips_params(data: Dict[str, np.ndarray], device="cuda") -> Dict[str, torch.Tensor]:
    """The .npz arrays -> float32 tensors on ``device``, conv kernels
    HWIO -> OIHW."""
    out = {}
    for k, v in data.items():
        v = np.asarray(v, np.float32)
        if k.endswith("_w"):
            v = v.transpose(3, 2, 0, 1)
        out[k] = torch.tensor(np.ascontiguousarray(v), device=torch.device(device))
    return out


def load_lpips(weights_path: Optional[str] = None,
               device="cuda") -> Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]]:
    """``lpips_fn(x, y)`` -> the mean distance of (N, H, W, 3) images in
    [0, 1] on ``device`` (the card unless the caller passes another), or
    None when the weights file is absent.  The file is ``weights_path``,
    else ``$V3D_TPU_LPIPS_WEIGHTS``, else weights/lpips_vgg.npz in the
    repository."""
    path = weights_path or os.environ.get("V3D_TPU_LPIPS_WEIGHTS", str(DEFAULT_WEIGHTS))
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        params = lpips_params(dict(data), device)

    def lpips_fn(x, y):
        return lpips_distance(params, x, y).mean()

    return lpips_fn


def convert_lpips_torch(state_dict) -> Dict[str, np.ndarray]:
    """A torch LPIPS (VGG) state dict (``net.slice*.N.*`` or flat
    ``features.N.*`` conv keys, ``lin*.model.1.weight`` heads) -> the .npz
    layout."""
    out = {}
    # torch vgg16.features indices of the 13 convs
    tv_idx = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    convs = {}
    for k, v in state_dict.items():
        for i, ti in enumerate(tv_idx):
            if k.endswith(f".{ti}.weight") and v.ndim == 4:
                convs[(i, "w")] = v.detach().cpu().numpy().transpose(2, 3, 1, 0)
            elif k.endswith(f".{ti}.bias") and v.ndim == 1:
                convs[(i, "b")] = v.detach().cpu().numpy()
    for i in range(len(tv_idx)):
        out[f"conv{i}_w"] = convs[(i, "w")]
        out[f"conv{i}_b"] = convs[(i, "b")]
    for li in range(5):
        for k, v in state_dict.items():
            if f"lin{li}" in k and k.endswith("weight"):
                out[f"lin{li}"] = v.detach().cpu().numpy().reshape(-1)
    return out
