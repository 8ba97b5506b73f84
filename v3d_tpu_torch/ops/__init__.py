"""Dispatchers, plain versions and launch counters of the port's kernels.

| kernel | wrapper | plain version | replaces (v3d_tpu) |
|---|---|---|---|
| K1 | attention.flash_attn_fwd (via flash_attention) | attention.flash_attn_fwd_plain | ops/attention.py attention_bhsd (flash_jax) |
| K2 | temporal_attention.temporal_block_attention | temporal_block_attention_plain | ops/temporal_attention.py _pallas_block |
| K3 | temporal_attention.temporal_core | temporal_core_plain | ops/temporal_attention.py _pallas_core |
| K4 (T10) | gs_composite.composite_fwd (via GSComposite) | gs_composite.composite_plain | gs/pallas_raster.py composite_tiles_fwd |
| K5 (T11) | gs_composite.composite_bwd (GSComposite backward) | autograd of composite_plain | gs/pallas_raster.py composite_tiles_bwd |
| K6 | group_norm.group_norm_fwd (via group_norm_act) | group_norm.group_norm_act_plain | ops/fused_groupnorm.py _pallas_group_norm |
| K6 split: statistics | group_norm.group_norm_stats_fwd (via group_norm_act_split) | group_norm.group_norm_stats_plain | ops/fused_groupnorm.py _pallas_group_norm's _stats_kernel call |
| K6 split: apply | group_norm.group_norm_apply_fwd (via group_norm_act_split) | group_norm.group_norm_apply_plain | ops/fused_groupnorm.py _pallas_group_norm's _norm_kernel call |
| K7 | attention.flash_attn_bwd (dk, dv; flash_attention's backward) | attention.flash_attn_bwd_plain | stock Pallas flash _flash_attention_bwd_dkv |
| K8 | attention.flash_attn_bwd (dq, first) | attention.flash_attn_bwd_plain | stock Pallas flash _flash_attention_bwd_dq |
| K9 | flash_attention.flash_attn_fwd_wide (d = 80, 128, 512) | flash_attention.flash_attn_fwd_wide_plain | ops/flash_attention.py _flash_forward / _flash_packed_forward |
| K10 | layer_norm.layer_norm_f32 (via models/layers.py LayerNormF32, where no gradient is wanted) | layer_norm.layer_norm_f32_plain | none: XLA fuses models/layers.py LayerNormF32 |

The JAX package's other attention kernels are routes onto these:
``flash_attention.flash_attention`` (T2, and T3 with ``heads_resident``) and
``flash_attention_packed`` (T4) on K1 or K9, ``temporal_attention`` /
``temporal_attention_mxu`` (T5, T6) on K3; ``attention.attention`` and
``attention_bhsd`` dispatch by the backend setters.

K6's split entries run where a GroupNorm's samples are spread over ranks
(``parallel.frames``), with the sums all-reduced between them.

K10 has no backward: a LayerNorm that wants a gradient takes the plain
formula (``layer_norm.layer_norm_route``).

The backwards of K2, K3, K6 and of the T2-T4 routes recompute through their
plain versions (``_dispatch.plain_vjp``), as the JAX package's custom VJPs
do.  ``step_graph.StepGraph`` replays a trainer's step from a CUDA graph
and counts the launches of each replay.
"""

from v3d_tpu_torch.ops._dispatch import (
    LAUNCHES,
    reference_mode,
    reset_launch_counts,
)
from v3d_tpu_torch.ops.attention import set_default_backend, set_spatial_override

__all__ = ["LAUNCHES", "reference_mode", "reset_launch_counts",
           "set_default_backend", "set_spatial_override"]
