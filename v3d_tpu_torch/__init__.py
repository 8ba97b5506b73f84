"""v3d_tpu_torch — the V3D image -> 18-view generation path in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100 (sm_90a).

A port of ``v3d_tpu`` (JAX/Flax/Pallas), which stays beside it as the
reference.  This package imports torch and never jax.

- ``ops``       kernel dispatchers (plain version on CPU, kernel on CUDA),
                plain versions, launch counters, ``reference_mode()``
- ``csrc``      the CUDA C++ kernels; ``kernels/build.py`` builds them
- ``diffusion`` EDM scaling, discretization, denoiser, guiders, Euler sampler
- ``models``    VideoUNet, the image UNet2D, VAE (+ image and temporal
                decoders), CLIP ViT-H, conditioner, regularizers, PatchGAN,
                PixelNeRF (+ ResUNet)
- ``engines``   the video and image diffusion engines, their builders (from
                code or a YAML config), the diffusion and autoencoder trainers
- ``metrics``   LPIPS
- ``data``      input-image preprocessing, orbit training data, prefetch,
                camera paths
- ``apps``      ``python -m v3d_tpu_torch.apps.generate`` and the other CLIs
- ``core``      weight bridge to and from the JAX package's param trees,
                YAML configs, the component registry
- ``parallel``  the ("data", "model") device mesh over torch.distributed
                ranks, batch sharding, the multi-rank dry run
"""

__version__ = "0.1.0"
