"""EDM diffusion math for sampling (counterpart of v3d_tpu/diffusion)."""

from v3d_tpu_torch.diffusion.denoise import Denoiser
from v3d_tpu_torch.diffusion.discretize import EDMDiscretization
from v3d_tpu_torch.diffusion.guidance import (
    LinearPredictionGuider,
    TrianglePredictionGuider,
)
from v3d_tpu_torch.diffusion.sampling import EulerEDMSampler
from v3d_tpu_torch.diffusion.scaling import VScalingWithEDMcNoise

__all__ = ["Denoiser", "EDMDiscretization", "EulerEDMSampler",
           "LinearPredictionGuider", "TrianglePredictionGuider",
           "VScalingWithEDMcNoise"]
