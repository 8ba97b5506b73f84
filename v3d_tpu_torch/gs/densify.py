"""Densification and pruning of the fixed-capacity gaussian arrays
(counterpart of v3d_tpu/gs/densify.py ``densify_and_prune_jnp`` and
``reset_opacity``, themselves of recon/scene/gaussian_model.py:273-280,
477-563).

Capacity is fixed: clones and split children are written into dead slots,
pruning clears ``alive``, so the trainer's tensors and Adam moments keep
their shape.  Everything runs on the tensors' device; nothing comes back to
the host.  Split offsets are standard normals drawn from a
``torch.Generator``, or given as ``samples`` (cap, 3) so that a test can feed
the same normals as the JAX package's ``jax.random.normal(key, (cap, 3))``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

PARAM_KEYS = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")


def _rank_to_slot(mask: torch.Tensor) -> torch.Tensor:
    """(cap,) bool -> (cap,) int64: slot index of the r-th True, cap if none."""
    cap = mask.shape[0]
    out = torch.full((cap + 1,), cap, dtype=torch.int64, device=mask.device)
    pos = torch.where(mask, torch.cumsum(mask, 0) - 1, cap)
    out[pos] = torch.arange(cap, device=mask.device)
    return out[:cap]


def _quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[:, 0:1], q[:, 1:2], q[:, 2:3], q[:, 3:4]
    n = torch.sqrt(w**2 + x**2 + y**2 + z**2) + 1e-12
    w, x, y, z = w / n, x / n, y / n, z / n
    vx, vy, vz = v[:, 0:1], v[:, 1:2], v[:, 2:3]
    rx = (1 - 2 * (y**2 + z**2)) * vx + 2 * (x * y - w * z) * vy + 2 * (x * z + w * y) * vz
    ry = 2 * (x * y + w * z) * vx + (1 - 2 * (x**2 + z**2)) * vy + 2 * (y * z - w * x) * vz
    rz = 2 * (x * z - w * y) * vx + 2 * (y * z + w * x) * vy + (1 - 2 * (x**2 + y**2)) * vz
    return torch.cat([rx, ry, rz], dim=1)


def _scatter(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """dst with rows idx set from src; rows with idx == len(dst) are dropped."""
    cap = dst.shape[0]
    out = torch.cat([dst, dst[:1]])
    out[idx] = src
    return out[:cap]


@torch.no_grad()
def densify_and_prune(params: Dict[str, torch.Tensor], alive: torch.Tensor,
                      grad_accum: torch.Tensor, denom: torch.Tensor,
                      max_radii: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      max_grad: float = 0.0002, min_opacity: float = 0.005,
                      extent: float = 2.0, max_screen_size: float = 0.0,
                      percent_dense: float = 0.01, n_split: int = 2,
                      samples: Optional[torch.Tensor] = None):
    """One densify + prune pass (gaussian_model.py:477-563).  Returns (new
    params, new alive, touched slots, stats as device scalars); the inputs
    are not modified."""
    cap = alive.shape[0]
    dev = alive.device
    grads = torch.where(denom > 0, grad_accum / torch.clamp(denom, min=1), 0.0)
    max_scale = torch.exp(params["scaling"]).amax(dim=1)

    high_grad = (grads >= max_grad) & alive
    clone_mask = high_grad & (max_scale <= percent_dense * extent)
    split_mask = high_grad & (max_scale > percent_dense * extent)
    free_mask = ~alive
    n_free = free_mask.sum()
    n_clone = clone_mask.sum()
    n_split_src = split_mask.sum()

    free_slot = _rank_to_slot(free_mask)
    clone_src = _rank_to_slot(clone_mask)
    split_src = _rank_to_slot(split_mask)
    idx = torch.arange(cap, device=dev)

    # clones take free ranks [0, nc), split children [nc, nc + n_children)
    nc = torch.minimum(n_clone, n_free)
    clone_dest = torch.where(idx < nc, free_slot, cap)
    clone_from = torch.where(idx < nc, clone_src, 0)
    n_children = torch.minimum(n_split_src * n_split,
                               torch.clamp(n_free - nc, min=0))
    child_ok = idx < n_children
    split_dest = torch.where(
        child_ok, free_slot[torch.clamp(nc + idx, max=cap - 1)], cap)
    split_from = torch.where(child_ok, split_src[idx // n_split], 0)

    new = {k: _scatter(params[k], clone_dest, params[k][clone_from])
           for k in PARAM_KEYS}
    if samples is None:
        samples = torch.randn(cap, 3, generator=generator, device=dev)
    std = torch.exp(params["scaling"][split_from])
    offset = _quat_rotate(params["rotation"][split_from], samples * std)
    child_xyz = params["xyz"][split_from] + offset
    child_scaling = torch.log(torch.exp(params["scaling"][split_from])
                              / (0.8 * n_split))
    for k in ("f_dc", "f_rest", "opacity", "rotation"):
        new[k] = _scatter(new[k], split_dest, params[k][split_from])
    new["xyz"] = _scatter(new["xyz"], split_dest, child_xyz)
    new["scaling"] = _scatter(new["scaling"], split_dest, child_scaling)

    touched = _scatter(_scatter(torch.zeros_like(alive), clone_dest,
                                torch.ones_like(alive)),
                       split_dest, torch.ones_like(alive))
    new_alive = alive | touched
    # prune only split sources whose children were placed: at capacity
    # saturation the others stay (densify.py:266-274)
    src_rank = torch.cumsum(split_mask, 0) - 1
    new_alive = new_alive & ~(split_mask & (src_rank * n_split < n_children))

    prune = (torch.sigmoid(new["opacity"][:, 0]) < min_opacity) & new_alive
    if max_screen_size > 0:
        # new slots have zero accumulated radii (densification_postfix)
        radii = torch.where(touched, 0.0, max_radii)
        prune |= (radii > max_screen_size) & new_alive
        prune |= (torch.exp(new["scaling"]).amax(dim=1) > 0.1 * extent) & new_alive
    new_alive = new_alive & ~prune
    stats = {"cloned": nc, "split": n_children, "pruned": prune.sum(),
             "out_of_capacity": (n_clone - nc) + (n_split_src * n_split - n_children)}
    return new, new_alive, touched, stats


@torch.no_grad()
def reset_opacity(opacity: torch.Tensor, max_opacity: float = 0.01) -> torch.Tensor:
    """gaussian_model.py:273-280: opacity logits clamped to at most
    ``max_opacity`` after the sigmoid."""
    op = torch.clamp(torch.sigmoid(opacity), max=max_opacity)
    return torch.log(op / (1 - op))
