"""Dispatchers, plain versions and launch counters of the port's kernels.

| kernel | wrapper | plain version | replaces (v3d_tpu) |
|---|---|---|---|
| K1 | attention.flash_attn_fwd | attention.flash_attn_fwd_plain | ops/attention.py attention_bhsd (flash_jax) |
| K2 | temporal_attention.temporal_block_attention | temporal_block_attention_plain | ops/temporal_attention.py _pallas_block |
| K3 | temporal_attention.temporal_core | temporal_core_plain | ops/temporal_attention.py _pallas_core |
| T10 | gs_composite.composite_fwd (via GSComposite) | gs_composite.composite_plain | gs/pallas_raster.py composite_tiles_fwd |
| T11 | gs_composite.composite_bwd (GSComposite backward) | autograd of composite_plain | gs/pallas_raster.py composite_tiles_bwd |
"""

from v3d_tpu_torch.ops._dispatch import (
    LAUNCHES,
    reference_mode,
    reset_launch_counts,
)

__all__ = ["LAUNCHES", "reference_mode", "reset_launch_counts"]
