"""v3d_tpu_torch — the V3D image -> 18-view generation path in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100 (sm_90a).

A port of ``v3d_tpu`` (JAX/Flax/Pallas), which stays beside it as the
reference.  This package imports torch and never jax.

- ``ops``       kernel dispatchers (plain version on CPU, kernel on CUDA),
                plain versions, launch counters, ``reference_mode()``
- ``csrc``      the CUDA C++ kernels; ``kernels/build.py`` builds them
- ``diffusion`` EDM scaling, discretization, denoiser, guiders, Euler sampler
- ``models``    VideoUNet, VAE (+ image and temporal decoders), CLIP ViT-H,
                conditioner, regularizers, PatchGAN, PixelNeRF (+ ResUNet)
- ``engines``   the generation engine, its builders, the diffusion and
                autoencoder trainers
- ``data``      input-image preprocessing, orbit training data, prefetch
- ``apps``      ``python -m v3d_tpu_torch.apps.generate``
- ``core``      weight bridge to and from the JAX package's param trees
"""

__version__ = "0.1.0"
