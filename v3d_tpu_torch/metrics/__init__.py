"""Evaluation metrics (counterpart of v3d_tpu/metrics): LPIPS; PSNR and
SSIM live in ``gs/losses.py``."""
