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

``densify_and_prune_np`` is the numpy reference path on the host (a copy
of v3d_tpu/gs/densify.py ``densify_and_prune``), drawing the split offsets
from a ``np.random.RandomState``; ``GSTrainConfig.host_densify`` selects it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
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


# ----------------------------------------------------------------------
# the host (numpy) path


@dataclasses.dataclass
class DensifyState:
    """Accumulated screen-gradient statistics
    (gaussian_model.py:107-110, 566-569), as numpy."""

    xyz_gradient_accum: np.ndarray  # (N,)
    denom: np.ndarray               # (N,)
    max_radii2d: np.ndarray         # (N,)

    @staticmethod
    def zeros(capacity: int) -> "DensifyState":
        return DensifyState(np.zeros(capacity, np.float32),
                            np.zeros(capacity, np.float32),
                            np.zeros(capacity, np.float32))


def _quat_rotate_np(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    w, x, y, z = q[:, 0:1], q[:, 1:2], q[:, 2:3], q[:, 3:4]
    n = np.sqrt(w**2 + x**2 + y**2 + z**2) + 1e-12
    w, x, y, z = w / n, x / n, y / n, z / n
    vx, vy, vz = v[:, 0:1], v[:, 1:2], v[:, 2:3]
    rx = (1 - 2 * (y**2 + z**2)) * vx + 2 * (x * y - w * z) * vy + 2 * (x * z + w * y) * vz
    ry = 2 * (x * y + w * z) * vx + (1 - 2 * (x**2 + z**2)) * vy + 2 * (y * z - w * x) * vz
    rz = 2 * (x * z - w * y) * vx + 2 * (y * z + w * x) * vy + (1 - 2 * (x**2 + y**2)) * vz
    return np.concatenate([rx, ry, rz], axis=1)


def densify_and_prune_np(g_np: Dict[str, np.ndarray], state: DensifyState,
                         rng: np.random.RandomState, max_grad: float = 0.0002,
                         min_opacity: float = 0.005, extent: float = 2.0,
                         max_screen_size: float = 0.0, percent_dense: float = 0.01,
                         n_split: int = 2) -> Tuple[Dict[str, np.ndarray], DensifyState, Dict]:
    """One densify + prune pass over a numpy dict of the gaussian fields and
    ``alive`` (gaussian_model.py:477-563), modified in place and returned
    with zeroed statistics and the counts.  Clones and split children take
    the free slots in slot order; split offsets are ``rng.randn``."""
    alive = g_np["alive"].copy()
    grads = np.where(state.denom > 0,
                     state.xyz_gradient_accum / np.maximum(state.denom, 1), 0.0)
    max_scale = np.exp(g_np["scaling"]).max(axis=1)

    high_grad = (grads >= max_grad) & alive
    clone_mask = high_grad & (max_scale <= percent_dense * extent)
    split_mask = high_grad & (max_scale > percent_dense * extent)

    free = np.nonzero(~alive)[0]
    stats = {"cloned": 0, "split": 0, "pruned": 0, "out_of_capacity": 0}

    def alloc(k):
        nonlocal free
        take = free[:k]
        free = free[k:]
        return take

    new_slots = np.zeros_like(alive)
    # clone: copy the small gaussians verbatim (gaussian_model.py:521-546)
    clone_idx = np.nonzero(clone_mask)[0]
    take = alloc(len(clone_idx))
    src = clone_idx[:len(take)]
    stats["cloned"] = len(take)
    stats["out_of_capacity"] += len(clone_idx) - len(take)
    for k in PARAM_KEYS:
        g_np[k][take] = g_np[k][src]
    alive[take] = True
    new_slots[take] = True

    # split: n_split samples of each large gaussian, shrunk by 0.8 n_split;
    # the source is pruned (gaussian_model.py:477-519)
    split_idx = np.nonzero(split_mask)[0]
    new_needed = len(split_idx) * n_split
    take = alloc(new_needed)
    stats["out_of_capacity"] += new_needed - len(take)
    src = np.repeat(split_idx, n_split)[:len(take)]
    stats["split"] = len(take)
    if len(take):
        std = np.exp(g_np["scaling"][src])
        samples = rng.randn(len(take), 3).astype(np.float32) * std
        offset = _quat_rotate_np(g_np["rotation"][src], samples)
        for k in ("f_dc", "f_rest", "opacity"):
            g_np[k][take] = g_np[k][src]
        g_np["rotation"][take] = g_np["rotation"][src]
        g_np["xyz"][take] = g_np["xyz"][src] + offset
        g_np["scaling"][take] = np.log(np.exp(g_np["scaling"][src]) / (0.8 * n_split))
        alive[take] = True
        new_slots[take] = True
    # prune only the split sources whose children were placed
    placed_src = split_idx[np.arange(len(split_idx)) * n_split < len(take)]
    alive[placed_src] = False

    # prune on the post-densification values (gaussian_model.py:548-563)
    opacity = 1.0 / (1.0 + np.exp(-g_np["opacity"][:, 0]))
    max_scale = np.exp(g_np["scaling"]).max(axis=1)
    prune = (opacity < min_opacity) & alive
    if max_screen_size > 0:
        # new slots have zero accumulated radii (densification_postfix)
        radii = np.where(new_slots, 0.0, state.max_radii2d)
        prune |= (radii > max_screen_size) & alive
        prune |= (max_scale > 0.1 * extent) & alive
    stats["pruned"] = int(prune.sum())
    alive &= ~prune

    g_np["alive"] = alive
    return g_np, DensifyState.zeros(len(alive)), stats
