"""Mesh extraction and mesh files (counterpart of v3d_tpu/meshops)."""
