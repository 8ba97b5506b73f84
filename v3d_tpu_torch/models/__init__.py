"""See the package docstring of v3d_tpu_torch."""
