"""EDM diffusion math (counterpart of v3d_tpu/diffusion): discretizations,
scalings, guiders, sigma samplers, weightings, denoisers and samplers; and
rectified flow's scaling and shifted schedule (FLUX.1), which the same
denoiser and Euler sampler run."""

from v3d_tpu_torch.diffusion.scaling import (
    EDMScaling,
    EpsScaling,
    VScaling,
    VScalingWithEDMcNoise,
    FlowScaling,
)
from v3d_tpu_torch.diffusion.discretize import (
    EDMDiscretization,
    LegacyDDPMDiscretization,
    ShiftedFlowDiscretization,
)
from v3d_tpu_torch.diffusion.guidance import (
    IdentityGuider,
    VanillaCFG,
    LinearPredictionGuider,
    TrianglePredictionGuider,
)
from v3d_tpu_torch.diffusion.sigma_sampling import EDMSampling, DiscreteSampling
from v3d_tpu_torch.diffusion.weighting import (
    UnitWeighting,
    EDMWeighting,
    VWeighting,
    EpsWeighting,
)
from v3d_tpu_torch.diffusion.denoise import Denoiser, DiscreteDenoiser
from v3d_tpu_torch.diffusion.sampling import (
    EulerEDMSampler,
    HeunEDMSampler,
    EulerAncestralSampler,
    DPMPP2SAncestralSampler,
    DPMPP2MSampler,
    LinearMultistepSampler,
    to_d,
)

__all__ = [
    "EDMScaling", "EpsScaling", "VScaling", "VScalingWithEDMcNoise",
    "FlowScaling", "EDMDiscretization", "LegacyDDPMDiscretization",
    "ShiftedFlowDiscretization", "IdentityGuider",
    "VanillaCFG", "LinearPredictionGuider", "TrianglePredictionGuider",
    "EDMSampling", "DiscreteSampling", "UnitWeighting", "EDMWeighting",
    "VWeighting", "EpsWeighting", "Denoiser", "DiscreteDenoiser",
    "EulerEDMSampler", "HeunEDMSampler", "EulerAncestralSampler",
    "DPMPP2SAncestralSampler", "DPMPP2MSampler", "LinearMultistepSampler",
    "to_d",
]
