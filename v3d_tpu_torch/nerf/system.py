"""NeuS training system (counterpart of v3d_tpu/nerf/system.py, itself of
mesh_recon/systems/neus_videonvs.py:37-503).

Per step: random pixels across all frames -> rays -> fixed-budget NeuS
render -> the loss suite (rgb MSE, mask BCE, eikonal, normal cosine,
sparsity, 3D normal smoothness, opaque, distortion) -> AdamW per parameter
group with a constant-then-exponential learning rate.  Dynamic ray sampling
adapts the ray count to a live-sample budget, rounded down to a power of
two (neus_videonvs.py:191-199).

A step's random draws are explicit (``NeusDraws``): the trainer makes them
from its ``torch.Generator``; a caller may hand in others (the JAX
package's, in the tests).  With a static ray count (no dynamic ray
sampling) and no per-step occupancy update, ``train`` runs chunks of steps
(``train_chunk``), the JAX package's schedule: the host works out each
step's level mask, FD eps, cos-anneal ratio and learning rates and makes
the chunk's draws in advance; on the card each step is a replay of one
step captured in a CUDA graph (the coarse-to-fine render, checkpointed
fields, the double backward of the exact gradient, AdamW), its inputs
written into the tensors the graph reads.  Every step, on the card or the
CPU, chunked or not, reads its schedule as a device row and its learning
rates as tensors; on the CPU a chunk runs its steps eagerly.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from v3d_tpu_torch.nerf.encoding import (
    VanillaFrequency,
    progressive_fd_eps,
    progressive_level_mask,
)
from v3d_tpu_torch.nerf.fields import (
    VarianceNetwork,
    VolumeDensity,
    VolumeRadiance,
    VolumeRadianceBg,
    VolumeSDF,
)
from v3d_tpu_torch.nerf.occupancy import OccupancyGrid
from v3d_tpu_torch.nerf.renderer import BgRenderer, NeusRenderer
from v3d_tpu_torch.ops.step_graph import StepGraph

ADAM_BETAS = (0.9, 0.99)
ADAM_EPS = 1e-15
WEIGHT_DECAY = 1e-4   # optax.adamw's default, which system.py:193-205 keeps


@dataclasses.dataclass
class NeusConfig:
    """configs/videonvs.yaml model / system blocks (every field and default
    of the JAX package's NeusConfig)."""

    radius: float = 1.0
    num_samples_per_ray: int = 1024
    train_num_rays: int = 256
    max_train_num_rays: int = 8192
    dynamic_ray_sampling: bool = True
    cos_anneal_end: int = 20000
    background_color: str = "black"
    grid_prune: bool = True
    grid_prune_occ_thre: float = 0.001
    use_occ_lookup: bool = True   # mask samples by the occupancy grid
    # > 0: coarse-to-fine sampling (renderer.sample_points_coarse_to_fine)
    coarse_to_fine_samples: int = 0
    variance_init: float = 0.3
    # learned background (neus.py:70-84, 193-270; off in the shipped configs)
    learned_background: bool = False
    num_samples_per_ray_bg: int = 64
    near_plane_bg: float = 0.1
    far_plane_bg: float = 1e3
    lambda_distortion_bg: float = 0.0
    # geometry field (reference: hashgrid + FD; card: frequency + analytic)
    geometry_encoding: str = "hashgrid"
    grad_type: str = "finite_difference"
    n_frequencies: int = 8
    geo_neurons: int = 64
    geo_hidden_layers: int = 1
    freq_masking_steps: int = 0
    ray_chunk: int = 0
    # hashgrid / progressive schedule
    n_levels: int = 10
    start_level: int = 4
    start_step: int = 0
    update_steps: int = 1000
    base_resolution: int = 32
    per_level_scale: float = 1.3195079107728942
    # losses (system.loss)
    lambda_rgb_mse: float = 0.5
    lambda_rgb_l1: float = 0.0
    lambda_mask: float = 1.0
    lambda_eikonal: float = 0.2
    lambda_normal: float = 1.0
    lambda_3d_normal_smooth: float = 1.0
    lambda_curvature: float = 0.0
    lambda_sparsity: float = 0.5
    lambda_distortion: float = 0.0
    lambda_opaque: float = 0.0
    sparsity_scale: float = 100.0
    normal_p_ratio: float = 0.8
    # optimizer (system.optimizer / scheduler)
    lr: float = 0.01
    lr_geometry: float = 0.001
    lr_variance: float = 0.001
    constant_steps: int = 500
    max_steps: int = 3000
    lr_decay_target: float = 0.1


class NeusDraws(NamedTuple):
    """One step's random draws (system.py:285-314, _sample_batch :261-283)."""

    idx: torch.Tensor        # (R,) int64 image index
    x: torch.Tensor          # (R,) int64 column
    y: torch.Tensor          # (R,) int64 row
    jitter: torch.Tensor     # (R, S) in [0, 1): sample placement
    rand_pts: torch.Tensor   # (R, 3) uniform in the cube: sparsity points
    perturb: torch.Tensor    # (R, 3) standard normal: the smoothness offsets
    bg_jitter: Optional[torch.Tensor] = None   # (R, 1), learned background


def ranking_loss(error, penalize_ratio: float = 0.7, mask=None,
                 reduction: str = "mean"):
    """neus_ortho.py:18-29: keep the smallest ``penalize_ratio`` of the
    errors; entries with mask 0 go to +inf and are excluded."""
    n = error.shape[0]
    if mask is not None:
        error = torch.where(mask, error, torch.inf)
        n_valid = mask.sum()
    else:
        n_valid = torch.full((), n, device=error.device)
    k = torch.clamp((penalize_ratio * n_valid).to(torch.int32), max=n)
    sorted_err = torch.sort(error).values
    keep = torch.arange(n, device=error.device) < k
    vals = torch.where(keep & torch.isfinite(sorted_err), sorted_err, 0.0)
    if reduction == "mean":
        return vals.sum() / torch.clamp(k, min=1)
    return vals.sum()


def binary_cross_entropy(pred, target):
    return -(target * torch.log(pred) + (1 - target) * torch.log(1 - pred))


def distortion_loss(weights, midpoints, intervals):
    """MipNeRF-360 distortion on the (R, S) layout, in its O(S) prefix-sum
    form."""
    w, m = weights, midpoints
    loss_intra = (w * w * intervals).sum(-1) / 3.0
    wm = w * m
    w_cum = torch.cumsum(w, -1)
    wm_cum = torch.cumsum(wm, -1)
    loss_inter = 2.0 * (w * (m * (w_cum - w) - (wm_cum - wm))).sum(-1)
    return (loss_intra + loss_inter).mean()


class NeusTrainer:
    """Owns the fields, the occupancy grid, the optimizer and the step.  The
    dataset (images, masks, normals, ray directions, poses) lives on
    ``device``: the card unless the caller passes ``device="cpu"``."""

    def __init__(self, images: np.ndarray, fg_masks: np.ndarray,
                 directions: np.ndarray, c2ws: np.ndarray,
                 normals: Optional[np.ndarray] = None,
                 origins: Optional[np.ndarray] = None,
                 view_weights: Optional[np.ndarray] = None,
                 config: NeusConfig = NeusConfig(), seed: int = 0,
                 device="cuda"):
        """images (N, H, W, 3) in [0, 1]; fg_masks (N, H, W); directions
        (H, W, 3) camera space, or (N, H, W, 3) per frame; c2ws (N, 4, 4)
        OpenGL; ``origins`` (H, W, 3) for orthographic cameras;
        ``view_weights`` (N,) per-view loss weights."""
        self.cfg = cfg = config
        self.device = dev = torch.device(device)
        self.geometry = VolumeSDF(
            radius=cfg.radius, encoding_type=cfg.geometry_encoding,
            n_levels=cfg.n_levels, base_resolution=cfg.base_resolution,
            per_level_scale=cfg.per_level_scale,
            n_frequencies=cfg.n_frequencies, grad_type=cfg.grad_type,
            n_neurons=cfg.geo_neurons, n_hidden_layers=cfg.geo_hidden_layers)
        self.texture = VolumeRadiance()
        self.variance = VarianceNetwork(init_val=cfg.variance_init)
        self.renderer = NeusRenderer(radius=cfg.radius,
                                     num_samples=cfg.num_samples_per_ray,
                                     ray_chunk=cfg.ray_chunk,
                                     coarse_samples=cfg.coarse_to_fine_samples)
        self.occ = OccupancyGrid(radius=cfg.radius,
                                 occ_threshold=cfg.grid_prune_occ_thre,
                                 device=dev)
        self.modules = {"geometry": self.geometry, "texture": self.texture,
                        "variance": self.variance}
        if cfg.learned_background:
            self.geometry_bg = VolumeDensity(radius=cfg.radius)
            self.texture_bg = VolumeRadianceBg()
            self.bg_renderer = BgRenderer(
                radius=cfg.radius, num_samples=cfg.num_samples_per_ray_bg,
                near_plane=cfg.near_plane_bg, far_plane=cfg.far_plane_bg)
            self.modules.update(geometry_bg=self.geometry_bg,
                                texture_bg=self.texture_bg)
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        for mod in self.modules.values():
            mod.to(dev)
            mod.init_(self.gen)

        def tensor(a):
            return None if a is None else torch.as_tensor(
                np.asarray(a, np.float32), device=dev)

        self.images = tensor(images)
        self.fg_masks = tensor(fg_masks)
        self.normals = tensor(normals)
        self.directions = tensor(directions)
        self.origins = tensor(origins)
        self.view_weights = tensor(view_weights)
        self.c2ws = tensor(c2ws)
        self.n_images, self.h, self.w = images.shape[:3]

        # bg fields train at the texture lr (instant-nsr-pl convention)
        self.base_lr = {"geometry": cfg.lr_geometry, "texture": cfg.lr,
                        "variance": cfg.lr_variance, "geometry_bg": cfg.lr,
                        "texture_bg": cfg.lr}
        # learning rates are tensors the step (and its graph) reads; AdamW
        # is capturable on the card, in the per-step path too, so that both
        # paths run the same update (the CPU has no capturable AdamW)
        self.on_card = dev.type == "cuda"
        self.opt = torch.optim.AdamW(
            [{"params": list(mod.parameters()), "name": name,
              "lr": torch.tensor(self.base_lr[name], device=dev)}
             for name, mod in self.modules.items()],
            betas=ADAM_BETAS, eps=ADAM_EPS, weight_decay=WEIGHT_DECAY,
            capturable=self.on_card)
        self.global_step = 0
        self.train_num_rays = cfg.train_num_rays
        self._graph: Optional[StepGraph] = None   # made at the first chunk
        self._inputs = None   # a chunk's step inputs (_StepInputs)

    # ------------------------------------------------------------------
    def lr_factor(self, step: int) -> float:
        """ConstantLR, then ExponentialLR with gamma such that the decay
        over the remaining steps is ``lr_decay_target``."""
        cfg = self.cfg
        gamma = cfg.lr_decay_target ** (1.0 / max(cfg.max_steps - cfg.constant_steps, 1))
        return gamma ** max(step - cfg.constant_steps, 0)

    def _level_mask_np(self) -> np.ndarray:
        cfg = self.cfg
        if cfg.geometry_encoding == "frequency":
            return VanillaFrequency(cfg.n_frequencies,
                                    cfg.freq_masking_steps).mask(self.global_step)
        return progressive_level_mask(self.global_step, cfg.n_levels, 2,
                                      cfg.start_level, cfg.start_step,
                                      cfg.update_steps)

    def _level_mask(self) -> torch.Tensor:
        return torch.as_tensor(self._level_mask_np(), device=self.device)

    def _fd_eps(self) -> float:
        cfg = self.cfg
        return progressive_fd_eps(self.global_step, cfg.radius,
                                  cfg.base_resolution, cfg.per_level_scale,
                                  cfg.start_level, cfg.start_step,
                                  cfg.update_steps, cfg.n_levels)

    def cos_anneal_ratio(self) -> float:
        end = self.cfg.cos_anneal_end
        return 1.0 if end == 0 else min(1.0, self.global_step / end)

    def inv_s(self):
        return self.variance().clamp(1e-6, 1e6)

    def _background(self) -> torch.Tensor:
        value = 0.0 if self.cfg.background_color == "black" else 1.0
        return torch.full((3,), value, device=self.device)

    @torch.no_grad()
    def _occ_eval(self, pts, level_mask):
        sdf = self.geometry.sdf(pts, level_mask)
        inv_s = self.inv_s()
        step = self.renderer.step_size
        prev_cdf = torch.sigmoid((sdf + step * 0.5) * inv_s)
        next_cdf = torch.sigmoid((sdf - step * 0.5) * inv_s)
        return ((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)).clamp(0.0, 1.0)

    # ------------------------------------------------------------------
    def make_draws(self, num_rays: int) -> NeusDraws:
        """A step's draws from the trainer's generator."""
        g, dev, cfg = self.gen, self.device, self.cfg
        R, S = num_rays, cfg.num_samples_per_ray
        idx = torch.randint(0, self.n_images, (R,), generator=g, device=dev)
        x = torch.randint(0, self.w, (R,), generator=g, device=dev)
        y = torch.randint(0, self.h, (R,), generator=g, device=dev)
        jitter = torch.rand((R, S), generator=g, device=dev)
        rand_pts = (torch.rand((R, 3), generator=g, device=dev) * 2 - 1) * cfg.radius
        perturb = torch.randn((R, 3), generator=g, device=dev)
        bg = (torch.rand((R, 1), generator=g, device=dev)
              if cfg.learned_background else None)
        return NeusDraws(idx, x, y, jitter, rand_pts, perturb, bg)

    def _sample_batch(self, d: NeusDraws):
        dirs_cam = (self.directions[d.idx, d.y, d.x] if self.directions.ndim == 4
                    else self.directions[d.y, d.x])
        c2w = self.c2ws[d.idx]
        rays_d = torch.einsum("nij,nj->ni", c2w[:, :3, :3], dirs_cam)
        rays_d = rays_d / (torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True) + 1e-12)
        if self.origins is not None:   # orthographic
            o_cam = self.origins[d.y, d.x]
            rays_o = torch.einsum("nij,nj->ni", c2w[:, :3, :3], o_cam) + c2w[:, :3, 3]
        else:
            rays_o = c2w[:, :3, 3]
        rgb = self.images[d.idx, d.y, d.x]
        fg = self.fg_masks[d.idx, d.y, d.x]
        normal = (self.normals[d.idx, d.y, d.x] if self.normals is not None
                  else torch.zeros_like(rays_d))
        vw = (self.view_weights[d.idx] if self.view_weights is not None
              else torch.ones_like(fg))
        return rays_o, rays_d, rgb, fg, normal, vw

    def _losses(self, d: NeusDraws, level_mask, fd_eps, cos_ratio, binary):
        """The loss terms of one step (system.py:297-400), in the JAX
        package's order; ``fd_eps`` and ``cos_ratio`` are numbers or 0-d
        tensors, ``binary`` the occupancy mask.  Returns (losses, n_live)."""
        cfg = self.cfg
        rays_o, rays_d, rgb_gt, fg, normal_gt, view_w = self._sample_batch(d)
        bg = self._background()
        if not cfg.learned_background:
            rgb_gt = rgb_gt * fg[:, None] + bg[None] * (1 - fg[:, None])
        inv_s = self.inv_s()
        field = functools.partial(self.geometry, eps=fd_eps, level_mask=level_mask)
        if cfg.grad_type == "finite_difference":
            # the reference budget's rays x samples x 7 field points: keep
            # only the inputs, recompute the field in the backward (as the
            # JAX step's jax.checkpoint does)
            plain = field

            def field(pts):
                # the field draws nothing: no RNG state to keep (and none to
                # reset inside a CUDA graph's capture)
                return checkpoint(plain, pts, use_reentrant=False,
                                  preserve_rng_state=False)

        out = self.renderer(
            rays_o, rays_d, field, self.texture, inv_s,
            cos_anneal_ratio=cos_ratio,
            occupancy_binary=binary if cfg.use_occ_lookup else None,
            background_color=None if cfg.learned_background else bg,
            jitter=d.jitter,
            sdf_fn=lambda p: self.geometry.sdf(p, level_mask))
        if cfg.learned_background:
            out_bg = self.bg_renderer(rays_o, rays_d, self.geometry_bg,
                                      self.texture_bg, background_color=bg,
                                      jitter=d.bg_jitter)
            comp_rgb = out.comp_rgb + out_bg.comp_rgb * (1.0 - out.opacity)[:, None]
            rays_valid = out.rays_valid | (out_bg.opacity > 0)
        else:
            out_bg = None
            comp_rgb = out.comp_rgb
            rays_valid = out.rays_valid

        losses = {}
        rgb_mask = rays_valid & (fg >= 0)
        err = ((comp_rgb - rgb_gt) ** 2).sum(-1) * view_w
        losses["rgb_mse"] = ranking_loss(err, 1.0, rgb_mask) * cfg.lambda_rgb_mse
        if self.normals is not None and cfg.lambda_normal > 0:
            cosines = (rays_d * normal_gt).sum(-1)
            cosines = torch.where(cosines > -0.1, 0.0, cosines)
            nmask = (fg > 0) & (cosines < -0.1)
            nrm_a = torch.sqrt((out.comp_normal ** 2).sum(-1) + 1e-12)
            nrm_b = torch.sqrt((normal_gt ** 2).sum(-1) + 1e-12)
            nerr = 1.0 - (out.comp_normal * normal_gt).sum(-1) / (nrm_a * nrm_b)
            w = torch.exp(cosines.abs()) * view_w
            nerr = nerr * w / w.sum().clamp(min=1e-12)
            losses["normal"] = ranking_loss(nerr, cfg.normal_p_ratio, nmask,
                                            reduction="sum") * cfg.lambda_normal
        # safe sqrt: FD gradients are exactly 0 outside the cube
        gnorm = torch.sqrt((out.sdf_grad ** 2).sum(-1) + 1e-12)
        losses["eikonal"] = ((gnorm - 1.0) ** 2).mean() * cfg.lambda_eikonal
        opac = out.opacity.clamp(1e-3, 1 - 1e-3)
        losses["mask"] = ((binary_cross_entropy(opac, fg) * view_w).sum()
                          / view_w.sum().clamp(min=1e-12)) * cfg.lambda_mask
        if cfg.lambda_opaque > 0:
            losses["opaque"] = binary_cross_entropy(opac, opac).mean() * cfg.lambda_opaque
        rand_sdf, rand_grad, _ = field(d.rand_pts)
        losses["sparsity"] = torch.exp(
            -cfg.sparsity_scale * rand_sdf.abs()).mean() * cfg.lambda_sparsity
        if cfg.lambda_3d_normal_smooth > 0:
            _, grad_p, _ = field(d.rand_pts + d.perturb * 1e-2)
            losses["3d_normal_smooth"] = (
                rand_grad - grad_p).abs().mean() * cfg.lambda_3d_normal_smooth
        if cfg.lambda_distortion > 0:
            losses["distortion"] = distortion_loss(
                out.weights, out.midpoints, out.intervals) * cfg.lambda_distortion
        if cfg.learned_background and cfg.lambda_distortion_bg > 0:
            losses["distortion_bg"] = distortion_loss(
                out_bg.weights, out_bg.midpoints,
                out_bg.intervals) * cfg.lambda_distortion_bg
        return losses, out.sample_mask.sum()

    def compute_grads(self, draws: NeusDraws, sched: Optional[torch.Tensor] = None,
                      binary: Optional[torch.Tensor] = None):
        """The step's losses and the parameters' gradients (in ``.grad``).
        ``sched``: the step's row of ``_schedule_table`` (default: the
        current step's), ``binary`` the occupancy mask (default: the
        grid's).  Returns (loss, losses, n_live)."""
        self.opt.zero_grad(set_to_none=False)
        if sched is None:
            sched = self._schedule_table([self.global_step])[0]
        m = sched.shape[0] - 2
        losses, n_live = self._losses(draws, sched[:m], sched[m], sched[m + 1],
                                      self.occ.binary if binary is None else binary)
        loss = sum(losses.values())
        loss.backward()
        for group in self.opt.param_groups:   # AdamW skips a None gradient
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        return loss.detach(), {k: v.detach() for k, v in losses.items()}, n_live

    def _set_lr(self, step: int) -> None:
        """Write step ``step``'s learning rates into the groups' lr tensors."""
        factor = self.lr_factor(step)
        for group in self.opt.param_groups:
            group["lr"].fill_(self.base_lr[group["name"]] * factor)

    def _step_schedule(self, step: int):
        """(level mask (numpy), FD eps, cos-anneal ratio) of step ``step``."""
        saved, self.global_step = self.global_step, step
        try:
            return self._level_mask_np(), self._fd_eps(), self.cos_anneal_ratio()
        finally:
            self.global_step = saved

    def _schedule_table(self, steps) -> torch.Tensor:
        """Rows [level mask | FD eps | cos ratio] of ``steps`` on the
        trainer's device (on the card copied from pinned memory, without a
        sync)."""
        rows = []
        for step in steps:
            mask, eps, cos = self._step_schedule(step)
            rows.append(np.concatenate([mask, [eps, cos]]).astype(np.float32))
        table = torch.from_numpy(np.stack(rows))
        if self.on_card:
            table = table.pin_memory()
        return table.to(self.device, non_blocking=True)

    def _step(self, draws: NeusDraws, sched: torch.Tensor, binary: torch.Tensor):
        """One step at the learning rates ``_set_lr`` wrote, on the schedule
        row ``sched`` and the occupancy mask ``binary``: device operations
        only, so that the card can capture it."""
        out = self.compute_grads(draws, sched, binary)
        self.opt.step()
        return out

    def _train_step(self, draws: NeusDraws):
        """The current step on ``draws``, eagerly."""
        self._set_lr(self.global_step)
        return self._step(draws, self._schedule_table([self.global_step])[0],
                          self.occ.binary)

    def _step_inputs(self, draws: NeusDraws) -> "_StepInputs":
        if self._inputs is None or not self._inputs.fits(draws):
            self._inputs = _StepInputs(draws, self._level_mask_np().size + 2,
                                       self.occ.binary)
            self._graph = None
        return self._inputs

    def train_chunk(self, n: int, draws=None) -> Dict:
        """``n`` steps at a static ray count, without occupancy updates
        (``train`` keeps per-step stepping where the grid is updated); the
        per-step schedules are worked out on the host first.  ``draws``: the
        n steps' ``NeusDraws`` (default: made now from the trainer's
        generator, in ``train_iter``'s order).  Each step reads its inputs
        from the tensors of ``_StepInputs``, written before it; on the card
        it is a replay of one step from a CUDA graph
        (``ops.step_graph.StepGraph``, warm-up steps and the capture at the
        trainer's first chunk), and a failed capture or replay raises.
        Returns the last step's loss and terms, as the JAX chunk does."""
        cfg = self.cfg
        assert not cfg.dynamic_ray_sampling, (
            "train_chunk needs a static ray count; use train_iter or "
            "disable dynamic_ray_sampling")
        num_rays = self._quantized_rays()
        if draws is None:
            draws = [self.make_draws(num_rays) for _ in range(n)]
        if len(draws) != n or any(d.idx.shape[0] != num_rays for d in draws):
            raise ValueError(f"train_chunk({n}) needs {n} draws of {num_rays} rays")
        first = self.global_step
        table = self._schedule_table(range(first, first + n))
        inp = self._step_inputs(draws[0])
        if self.on_card and self._graph is None:
            self._graph = StepGraph(self.device)

        def step():
            return self._step(inp.draws, inp.sched, inp.binary)

        for i in range(n):
            self._set_lr(first + i)
            inp.load(draws[i], table[i], self.occ.binary)
            loss, losses, _ = self._graph(step) if self._graph else step()
            self.global_step = first + i + 1
        return {"loss": loss.clone(), "num_rays": num_rays,
                **{k: v.clone() for k, v in losses.items()}}

    # ------------------------------------------------------------------
    def train_iter(self, draws: Optional[NeusDraws] = None,
                   occ_offsets: Optional[torch.Tensor] = None) -> Dict:
        """One step: the occupancy update (every 16 steps, when the lookup
        is on), the AdamW step, the ray count's adaptation.  ``draws`` and
        ``occ_offsets`` replace the trainer's own draws."""
        cfg = self.cfg
        if cfg.grid_prune and cfg.use_occ_lookup:
            level_mask = self._level_mask()
            self.occ.update(self.global_step,
                            lambda pts: self._occ_eval(pts, level_mask),
                            offsets=occ_offsets, generator=self.gen)
        num_rays = self._quantized_rays()
        if draws is None:
            draws = self.make_draws(num_rays)
        elif draws.idx.shape[0] != num_rays:
            raise ValueError(f"draws for {draws.idx.shape[0]} rays, step needs {num_rays}")
        loss, losses, n_live = self._train_step(draws)
        self.global_step += 1
        if cfg.dynamic_ray_sampling:
            budget = cfg.train_num_rays * 64
            live = max(float(n_live), 1.0)
            target = int(num_rays * budget / live)
            self.train_num_rays = min(int(self.train_num_rays * 0.9 + target * 0.1),
                                      cfg.max_train_num_rays)
        return {"loss": loss, "num_rays": num_rays, **losses}

    def train(self, num_steps: int, chunk: int = 50, log_every: int = 0,
              log_fn=None) -> Dict:
        """``num_steps`` steps; ``log_fn(stats)`` after every
        ``log_every``-th.  With dynamic ray sampling, or an occupancy lookup
        whose grid is updated, every step goes through ``train_iter``;
        otherwise the segments between log points run as chunks of
        ``chunk`` steps and their remainder through ``train_iter`` (the JAX
        trainer's schedule)."""
        cfg = self.cfg
        stats: Dict = {}
        if cfg.dynamic_ray_sampling or (cfg.grid_prune and cfg.use_occ_lookup):
            for _ in range(num_steps):
                stats = self.train_iter()
                if log_every and log_fn and self.global_step % log_every == 0:
                    log_fn(stats)
            return stats
        end = self.global_step + num_steps
        while self.global_step < end:
            it = self.global_step
            nxt = end
            if log_every:
                nxt = min(nxt, (it // log_every + 1) * log_every)
            seg = nxt - it
            while seg >= chunk > 1:
                stats = self.train_chunk(chunk)
                seg -= chunk
            for _ in range(seg):
                stats = self.train_iter()
            if log_every and log_fn and self.global_step % log_every == 0:
                log_fn(stats)
        return stats

    def _quantized_rays(self) -> int:
        """The adaptive ray count, rounded down to a power of two."""
        n = max(self.cfg.train_num_rays, min(self.train_num_rays,
                                             self.cfg.max_train_num_rays))
        return 1 << int(np.floor(np.log2(n)))

    # ------------------------------------------------------------------
    def vertex_colors(self, verts: np.ndarray, chunk: int = 65536) -> np.ndarray:
        """RGB of mesh vertices from the radiance field, the normal from the
        SDF's gradient (models/neus.py:424-441)."""
        level_mask = self._level_mask()
        eps = self._fd_eps()
        out = []
        with torch.no_grad():
            for s in range(0, len(verts), chunk):
                pts = torch.as_tensor(np.asarray(verts[s:s + chunk], np.float32),
                                      device=self.device)
                _, grad, feat = self.geometry(pts, eps=eps, level_mask=level_mask)
                nrm = grad / (torch.linalg.vector_norm(grad, dim=-1, keepdim=True) + 1e-10)
                out.append(self.texture(feat, nrm).cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0, 3), np.float32)

    def render_image(self, c2w: np.ndarray, chunk: int = 4096, view_idx: int = 0):
        """Full-frame render (neus_videonvs.py:340-400) -> (rgb (H, W, 3),
        opacity (H, W), depth (H, W)) numpy."""
        dirs = self.directions
        if dirs.ndim == 4:
            dirs = dirs[view_idx]
        dirs = dirs.reshape(-1, 3)
        c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=self.device)
        rays_d = dirs @ c2w[:3, :3].T
        rays_d = rays_d / (torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True) + 1e-12)
        rays_o = c2w[:3, 3].expand(rays_d.shape)
        level_mask = self._level_mask()
        eps = self._fd_eps()
        bg = self._background()
        outs = []
        with torch.no_grad():
            inv_s = self.inv_s()
            for s in range(0, rays_d.shape[0], chunk):
                ro, rd = rays_o[s:s + chunk], rays_d[s:s + chunk]
                out = self.renderer(
                    ro, rd, functools.partial(self.geometry, eps=eps,
                                              level_mask=level_mask),
                    self.texture, inv_s, cos_anneal_ratio=self.cos_anneal_ratio(),
                    occupancy_binary=self.occ.binary,
                    background_color=None if self.cfg.learned_background else bg,
                    sdf_fn=lambda p: self.geometry.sdf(p, level_mask))
                comp_rgb = out.comp_rgb
                if self.cfg.learned_background:
                    out_bg = self.bg_renderer(ro, rd, self.geometry_bg,
                                              self.texture_bg, background_color=bg)
                    comp_rgb = comp_rgb + out_bg.comp_rgb * (1.0 - out.opacity)[:, None]
                outs.append((comp_rgb, out.opacity, out.depth))
        rgb, opac, depth = (torch.cat(x).cpu().numpy() for x in zip(*outs))
        return (rgb.reshape(self.h, self.w, 3), opac.reshape(self.h, self.w),
                depth.reshape(self.h, self.w))

    # ------------------------------------------------------------------
    def capture(self) -> Dict:
        """Resumable state: every group's parameters and AdamW moments, the
        occupancy grid, the step, the generator and the ray count."""
        params, adam = {}, {}
        for name, mod in self.modules.items():
            params[name] = {k: v.detach().clone() for k, v in mod.named_parameters()}
            adam[name] = {}
            for k, p in mod.named_parameters():
                st = self.opt.state.get(p, {})
                if st:
                    adam[name][k] = {"exp_avg": st["exp_avg"].clone(),
                                     "exp_avg_sq": st["exp_avg_sq"].clone(),
                                     "step": int(st["step"])}
        return {"params": params, "adam": adam, "step": self.global_step,
                "occs": self.occ.occs.clone(), "binary": self.occ.binary.clone(),
                "train_num_rays": self.train_num_rays,
                "generator": self.gen.get_state()}

    @torch.no_grad()
    def restore(self, state: Dict) -> None:
        """Load a ``capture()`` (or ``core.convert.trainer_state_from_jax``'s
        NeuS state: numpy leaves, no generator)."""
        dev = self.device

        def t(a):
            return torch.as_tensor(a if torch.is_tensor(a) else np.array(a),
                                   device=dev)

        for name, mod in self.modules.items():
            named = dict(mod.named_parameters())
            for k, v in state["params"][name].items():
                named[k].copy_(t(v).reshape(named[k].shape))
            for k, st in state.get("adam", {}).get(name, {}).items():
                p = named[k]
                self.opt.state[p] = {
                    "step": torch.tensor(float(st["step"]),
                                         device=dev if self.on_card else "cpu"),
                    "exp_avg": t(st["exp_avg"]).reshape(p.shape).float().clone(),
                    "exp_avg_sq": t(st["exp_avg_sq"]).reshape(p.shape).float().clone()}
        self.global_step = int(state["step"])
        self.occ.occs = t(state["occs"]).float().clone()
        self.occ.binary = t(state["binary"]).bool().clone()
        self.train_num_rays = int(state["train_num_rays"])
        if "generator" in state:
            g = state["generator"]
            self.gen.set_state(g if torch.is_tensor(g)
                               else torch.as_tensor(np.asarray(g, np.uint8)))
        self._graph = None   # AdamW's state was replaced

    def save(self, path: str) -> None:
        """``capture()`` as one .npz (``core.checkpoint.save_trainer_state``)."""
        from v3d_tpu_torch.core.checkpoint import save_trainer_state

        save_trainer_state(path, self.capture())

    def load(self, path: str) -> None:
        from v3d_tpu_torch.core.checkpoint import load_trainer_state

        self.restore(load_trainer_state(path))

    def sdf_grid(self, lo=None, hi=None, *, resolution: int = 128) -> np.ndarray:
        """The SDF on a regular (res, res, res) grid from corner ``lo`` to
        ``hi`` (default: the scene cube), generated on the device in slabs of
        x-slices; also ``grid_fn`` of ``meshops.mcubes.isosurface``."""
        r = self.cfg.radius
        corners = []
        for name, v, default in (("lo", lo, -r), ("hi", hi, r)):
            v = np.full(3, default, np.float32) if v is None else np.asarray(v, np.float32)
            if v.shape != (3,):
                raise ValueError(f"sdf_grid: {name} must be a corner of shape (3,), "
                                 f"got shape {v.shape}; pass the grid size as "
                                 f"resolution=...")
            corners.append(torch.as_tensor(v, device=self.device))
        lo_t, hi_t = corners
        res = int(resolution)
        step = (hi_t - lo_t) / (res - 1)
        ar = torch.arange(res, dtype=torch.float32, device=self.device)
        yy, zz = torch.meshgrid(lo_t[1] + ar * step[1], lo_t[2] + ar * step[2],
                                indexing="ij")
        level_mask = self._level_mask()
        per = max(1, (1 << 21) // (res * res))   # x-slices per field call
        out = torch.empty((res, res, res), device=self.device)
        with torch.no_grad():
            for s in range(0, res, per):
                xs = lo_t[0] + ar[s:s + per] * step[0]
                n = xs.shape[0]
                pts = torch.stack([xs[:, None, None].expand(n, res, res),
                                   yy.expand(n, res, res), zz.expand(n, res, res)], -1)
                out[s:s + n] = self.geometry.sdf(pts.reshape(-1, 3),
                                                 level_mask).reshape(n, res, res)
        return out.cpu().numpy()


class _StepInputs:
    """The tensors a chunk's steps read (and the card's CUDA graph
    captures): the draws, the schedule row [level mask | FD eps | cos
    ratio] and the occupancy mask, written in place before each step."""

    def __init__(self, draws: NeusDraws, sched_size: int, binary: torch.Tensor):
        self.draws = NeusDraws(*(None if x is None else torch.empty_like(x)
                                 for x in draws))
        self.sched = torch.empty(sched_size, device=draws.idx.device)
        self.binary = torch.empty_like(binary)

    def fits(self, draws: NeusDraws) -> bool:
        return all((a is None) == (b is None) and (a is None or a.shape == b.shape)
                   for a, b in zip(self.draws, draws))

    def load(self, draws: NeusDraws, row: torch.Tensor, binary: torch.Tensor) -> None:
        for dst, src in zip(self.draws, draws):
            if dst is not None:
                dst.copy_(src)
        self.sched.copy_(row)
        self.binary.copy_(binary)
