"""NeuS: SDF fields, renderer, trainer (counterpart of v3d_tpu/nerf)."""
