"""3D Gaussian Splatting fit (counterpart of v3d_tpu/gs)."""
