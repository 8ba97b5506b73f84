"""Utilities (counterpart of v3d_tpu/utils)."""
