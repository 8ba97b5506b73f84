"""3DGS fitting loop (counterpart of v3d_tpu/gs/trainer.py, itself of
recon/train_from_vid.py:38-208).

Each step renders one training view, takes L1 + SSIM (+ LPIPS where a
``lpips_fn`` is given) + an opacity penalty, backpropagates through the compositor (T10 forward, T11 backward on the
card) and the projection, and takes an Adam step; densify/prune events and
opacity resets come at exact iteration multiples.  Parameters, Adam moments
and the densification statistics stay on the device for the whole fit:
capacity is fixed, densification rewrites dead slots, and the optimizer
surgery of the reference (gaussian_model.py:375-445) becomes zeroing the
moments of the changed slots.

``train`` runs the segments between densify, opacity-reset and log
boundaries as chunks of ``chunk_size`` steps (``train_chunk``), the JAX
package's schedule, and the remainder through ``train_iter``.  On the card
a chunk replays a CUDA graph of one training step (render, loss, backward,
Adam, opacity decay, densification statistics), captured once per trainer
after a few eager warm-up steps: the host writes the step's camera index,
background and xyz learning rate into the tensors the graph reads and
launches nothing else, so a step costs the card's time and not the host's
dispatch of a few hundred kernels.  Every step, chunked or not, on the card
or the CPU, reads those input tensors; only the graph is the card's (on the
CPU a chunk runs its steps eagerly).  ``cfg.host_densify`` runs densification in numpy on the host
(``densify.densify_and_prune_np``) instead of on the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from v3d_tpu_torch.gs.densify import (
    DensifyState,
    densify_and_prune,
    densify_and_prune_np,
    reset_opacity,
)
from v3d_tpu_torch.gs.gaussians import (
    FLOAT_FIELDS,
    Gaussians,
    from_pcd,
    random_init_pcd,
)
from v3d_tpu_torch.gs.losses import l1_loss, ssim
from v3d_tpu_torch.gs.render import RasterizeConfig, render
from v3d_tpu_torch.ops.step_graph import StepGraph

ADAM_EPS = 1e-15


@dataclasses.dataclass
class GSTrainConfig:
    """OptimizationParams (recon/arguments/__init__.py:88-108) +
    train_from_vid defaults, every field of the JAX package's GSTrainConfig;
    V3D's readme step 4 runs 4000 iterations with lambda_dssim 1.0 and
    lambda_lpips 2.0."""

    iterations: int = 4000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    lambda_dssim: float = 0.2
    lambda_lpips: float = 0.0
    lambda_opacity: float = 0.1
    percent_dense: float = 0.01
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    min_opacity: float = 0.005
    white_background: bool = True
    # "hard": the reference's opacity resets (clamp to 0.01 every
    # opacity_reset_interval and at densify_from_iter on white backgrounds);
    # "none" with opacity_decay < 1 is the shipped transient-free recipe
    opacity_reset_mode: str = "hard"
    opacity_decay: float = 1.0
    max_per_tile: int = 256
    tile_chunk: int = 32
    coarse_factor: int = 8
    max_per_coarse: int = 2048
    random_background: bool = False
    # steps per ``train_chunk`` in ``train`` (one CUDA graph replay a step
    # on the card); 1 steps through ``train_iter`` only
    chunk_size: int = 50
    # densify on the host in numpy (the reference path) instead of the device
    host_densify: bool = False


def expon_lr(step, lr_init, lr_final, lr_delay_mult=1.0, lr_delay_steps=0,
             max_steps=1_000_000) -> float:
    """recon/utils/general_utils.py get_expon_lr_func."""
    t = min(max(step / max_steps, 0.0), 1.0)
    log_lerp = math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)
    delay = 1.0
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
    return delay * log_lerp


def camera_extent(cameras: List) -> float:
    """getNerfppNorm (recon/scene/dataset_readers.py): 1.1 * max distance of
    camera centers from their mean."""
    centers = np.stack([c.camera_center for c in cameras])
    return float(1.1 * np.linalg.norm(centers - centers.mean(0), axis=1).max())


def _pick(x: torch.Tensor, idx) -> torch.Tensor:
    """``x[idx]`` as a gather, ``idx`` an int or a 0-d index tensor (no
    host read)."""
    return x.index_select(0, torch.as_tensor(idx, device=x.device).reshape(1))[0]


class GSTrainer:
    """Fits gaussians to a set of posed images (the VideoNVS scene) on
    ``device`` (the card unless the caller passes ``device="cpu"``).
    ``lpips_fn(image, target)`` on (1, H, W, 3) tensors adds
    ``lambda_lpips`` times its value to the loss."""

    def __init__(self, cameras: List, config: GSTrainConfig = GSTrainConfig(),
                 num_pts: int = 100_000, capacity: Optional[int] = None,
                 seed: int = 0, sh_degree: int = 0, radius: float = 2.0,
                 lpips_fn: Optional[Callable] = None, device="cuda"):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.cams = cameras
        self.cfg = config
        self.lpips_fn = lpips_fn
        self.rng = np.random.RandomState(seed)
        # seeded from ``rng`` at the first device densify event, as the JAX
        # trainer derives its densify key, so both draw the same cameras
        self.gen: Optional[torch.Generator] = None
        self.extent = camera_extent(cameras)
        xyz, colors = random_init_pcd(self.rng, num_pts, radius=radius)
        g = from_pcd(xyz, colors, sh_degree=sh_degree,
                     capacity=capacity or int(num_pts * 2), device=self.device)
        self.alive = g.alive
        self.params = {k: getattr(g, k).requires_grad_() for k in FLOAT_FIELDS}
        cap = g.capacity
        self.stats = {k: torch.zeros(cap, device=self.device)
                      for k in ("grad_accum", "denom", "max_radii")}

        def stack(xs):
            return torch.tensor(np.stack(xs), dtype=torch.float32,
                                device=self.device)

        self.images = stack([c.image for c in cameras])
        self.cam_wvt = stack([c.world_view_transform for c in cameras])
        self.cam_fpt = stack([c.full_proj_transform for c in cameras])
        self.cam_center = stack([c.camera_center for c in cameras])
        self.template_cam = cameras[0]
        self.ndc_scale = torch.tensor(
            [0.5 * self.template_cam.width, 0.5 * self.template_cam.height],
            device=self.device)
        self.raster = RasterizeConfig(config.max_per_tile, config.tile_chunk,
                                      config.coarse_factor,
                                      config.max_per_coarse)
        self.step_count = 0
        # the xyz lr is a tensor the step (and its graph) reads, written
        # before each step
        lrs = {"xyz": torch.tensor(self._xyz_lr(0), device=self.device),
               "f_dc": config.feature_lr, "f_rest": config.feature_lr / 20.0,
               "opacity": config.opacity_lr, "scaling": config.scaling_lr,
               "rotation": config.rotation_lr}
        # capturable on the card, in the per-step path too, so that both
        # paths run the same update (the CPU has no capturable Adam)
        self.opt = torch.optim.Adam(
            [{"params": [self.params[k]], "lr": lrs[k], "name": k}
             for k in FLOAT_FIELDS], eps=ADAM_EPS, capturable=self.on_card)
        # the step's other inputs: the view index and the background
        self._cam = torch.zeros((), dtype=torch.int64, device=self.device)
        self._bg = self._background()
        self._graph: Optional[StepGraph] = None   # made at the first chunk

    # ------------------------------------------------------------------
    def _xyz_lr(self, step: int) -> float:
        c = self.cfg
        return expon_lr(step, c.position_lr_init * self.extent,
                        c.position_lr_final * self.extent,
                        c.position_lr_delay_mult,
                        max_steps=c.position_lr_max_steps)

    def _background(self, rand: Optional[np.ndarray] = None) -> torch.Tensor:
        if rand is not None:
            return torch.tensor(rand, dtype=torch.float32, device=self.device)
        return torch.full((3,), 1.0 if self.cfg.white_background else 0.0,
                          device=self.device)

    def _render(self, cam_idx, bg: torch.Tensor, screen_offset=None):
        g = Gaussians(alive=self.alive, **self.params)
        cam = dataclasses.replace(
            self.template_cam, world_view_transform=_pick(self.cam_wvt, cam_idx),
            full_proj_transform=_pick(self.cam_fpt, cam_idx),
            camera_center=_pick(self.cam_center, cam_idx), image=None)
        return render(g, cam, bg, config=self.raster,
                      screen_offset=screen_offset)

    def compute_grads(self, cam_idx, bg: Optional[torch.Tensor] = None):
        """Render view ``cam_idx`` (an int or a 0-d device tensor), take the
        loss and backpropagate: the parameters' ``.grad`` hold the step's
        gradients.  Returns (loss, render output, gradient of the
        screen-space offset)."""
        cfg = self.cfg
        if bg is None:
            bg = self._background(self.rng.rand(3) if cfg.random_background else None)
        self.opt.zero_grad(set_to_none=True)
        screen_offset = torch.zeros(self.alive.shape[0], 2, device=self.device,
                                    requires_grad=True)
        out = self._render(cam_idx, bg, screen_offset)
        target = _pick(self.images, cam_idx)
        loss = (1.0 - cfg.lambda_dssim) * l1_loss(out.image, target)
        if cfg.lambda_dssim > 0:
            loss = loss + cfg.lambda_dssim * (1.0 - ssim(out.image, target))
        if cfg.lambda_lpips > 0 and self.lpips_fn is not None:
            loss = loss + cfg.lambda_lpips * self.lpips_fn(out.image[None], target[None])
        op = torch.sigmoid(self.params["opacity"][:, 0]) * self.alive
        loss = loss + cfg.lambda_opacity * op.sum() / torch.clamp(
            self.alive.sum(), min=1)
        loss.backward()
        return loss.detach(), out, screen_offset.grad

    def _step(self) -> torch.Tensor:
        """One step on the inputs ``_set_inputs`` wrote: gradients, Adam,
        opacity decay, densification statistics.  Everything is a device
        operation (no host read), so that the card can capture it."""
        cfg = self.cfg
        loss, out, screen_grad = self.compute_grads(self._cam, self._bg)
        self.opt.step()
        with torch.no_grad():
            if cfg.opacity_decay < 1.0:
                # per-step multiplicative opacity decay: the floater pressure
                # of the transient-free recipe
                op = torch.clamp(torch.sigmoid(self.params["opacity"])
                                 * cfg.opacity_decay, 1e-6, 1 - 1e-6)
                self.params["opacity"].copy_(torch.log(op / (1 - op)))
            # densification statistics in the CUDA rasterizer's NDC units
            # (its backward scales dL/dmean2D by 0.5 W, 0.5 H), for which
            # densify_grad_threshold is calibrated
            visible = out.radii > 0
            gnorm = torch.linalg.norm(screen_grad * self.ndc_scale, dim=-1)
            self.stats["grad_accum"] += torch.where(visible, gnorm, 0.0)
            self.stats["denom"] += visible
            torch.maximum(self.stats["max_radii"],
                          torch.where(visible, out.radii, 0.0),
                          out=self.stats["max_radii"])
        return loss

    def _set_inputs(self, step: int, cam_idx: int, rand_bg: Optional[np.ndarray]):
        """Write step ``step`` (0-based)'s inputs into the tensors the step
        reads: the xyz learning rate (the schedule at the Adam step count
        before the update, as optax's scale_by_schedule reads it), the
        camera index and a random background.  Fills only: no sync."""
        self.opt.param_groups[0]["lr"].fill_(self._xyz_lr(step))
        self._cam.fill_(int(cam_idx))
        if rand_bg is not None:
            for c in range(3):
                self._bg[c].fill_(float(rand_bg[c]))

    def train_iter(self, cam_idx: Optional[int] = None) -> Dict:
        """One step on view ``cam_idx`` (drawn from the trainer's numpy
        generator when None), then the events due at the new step count.
        The loss stays a device scalar."""
        self.step_count += 1
        if cam_idx is None:
            cam_idx = int(self.rng.randint(len(self.cams)))
        rand_bg = self.rng.rand(3) if self.cfg.random_background else None
        self._set_inputs(self.step_count - 1, cam_idx, rand_bg)
        stats = {"loss": self._step(), "iter": self.step_count}
        self._maybe_events(stats)
        return stats

    def train_chunk(self, n: int, cam_indices: Optional[np.ndarray] = None) -> Dict:
        """``n`` steps, then the events due at the new step count (the
        caller keeps chunks between event boundaries, as ``train`` does).
        The draws are the JAX chunk's: the n camera indices, then (random
        background) the n backgrounds.  On the card: replays of one step
        from a CUDA graph (``ops.step_graph.StepGraph``: a few eager
        warm-up steps at the trainer's first chunk, then one capture; they
        are steps of the chunk too); a failed capture or replay raises.
        Returns {"loss", "losses" (n,), "iter"}."""
        if cam_indices is None:
            cam_indices = self.rng.randint(len(self.cams), size=n)
        cam_indices = np.asarray(cam_indices)
        bgs = (self.rng.rand(n, 3).astype(np.float32)
               if self.cfg.random_background else [None] * n)
        losses = torch.empty(n, device=self.device)
        if self.on_card and self._graph is None:
            self._graph = StepGraph(self.device)
        for i in range(n):
            self.step_count += 1
            self._set_inputs(self.step_count - 1, int(cam_indices[i]), bgs[i])
            losses[i] = self._graph(self._step) if self._graph else self._step()
        stats = {"loss": losses[-1], "losses": losses, "iter": self.step_count}
        self._maybe_events(stats)
        return stats

    def _maybe_events(self, stats: Dict) -> None:
        """Densify / opacity-reset events due at the current step count."""
        cfg = self.cfg
        it = self.step_count
        if it >= cfg.densify_until_iter:
            return
        if it > cfg.densify_from_iter and it % cfg.densification_interval == 0:
            stats.update(self._densify_event())
        if cfg.opacity_reset_mode == "hard" and (
                it % cfg.opacity_reset_interval == 0
                or (cfg.white_background and it == cfg.densify_from_iter)):
            with torch.no_grad():
                op = self.params["opacity"]
                op.copy_(reset_opacity(op))
            self._surgery(torch.ones_like(self.alive), fields=("opacity",))

    def train(self, num_iters: int, log_every: int = 0, log_fn=None) -> Dict:
        """``num_iters`` steps in chunks of ``chunk_size`` between the
        densify / opacity-reset / log boundaries, the remainder of each
        segment through ``train_iter`` (the JAX trainer's schedule, so
        events and logs fall on the same iterations); ``log_fn(stats)``
        after every ``log_every``-th step and after the last."""
        cfg = self.cfg
        C = cfg.chunk_size
        end = self.step_count + num_iters
        stats: Dict = {}
        while self.step_count < end:
            it = self.step_count
            boundaries = []
            if it < cfg.densify_until_iter:
                boundaries.append((it // cfg.densification_interval + 1)
                                  * cfg.densification_interval)
                boundaries.append((it // cfg.opacity_reset_interval + 1)
                                  * cfg.opacity_reset_interval)
                if cfg.white_background and it < cfg.densify_from_iter:
                    boundaries.append(cfg.densify_from_iter)
            if log_every:
                boundaries.append((it // log_every + 1) * log_every)
            seg = min([end] + [b for b in boundaries if b > it]) - it
            while seg >= C > 1:
                stats = self.train_chunk(C)
                seg -= C
            for _ in range(seg):
                stats = self.train_iter()
            if log_every and log_fn and (self.step_count % log_every == 0
                                         or self.step_count >= end):
                log_fn(stats)
        return stats

    def _size_threshold(self) -> float:
        # screen-size pruning: from the first opacity reset in "hard" mode
        # (train_from_vid.py:193), from densify start otherwise
        cfg = self.cfg
        if cfg.opacity_reset_mode == "hard":
            return 20.0 if self.step_count > cfg.opacity_reset_interval else 0.0
        return 20.0

    def _densify_event(self) -> Dict:
        cfg = self.cfg
        if cfg.host_densify:
            return self._densify_event_host()
        if self.gen is None:
            self.gen = torch.Generator(device=self.device).manual_seed(
                int(self.rng.randint(2**31)))
        old_alive = self.alive.clone()
        new, new_alive, touched, dstats = densify_and_prune(
            {k: p.detach() for k, p in self.params.items()}, old_alive,
            self.stats["grad_accum"], self.stats["denom"],
            self.stats["max_radii"], generator=self.gen,
            max_grad=cfg.densify_grad_threshold, min_opacity=cfg.min_opacity,
            extent=self.extent, max_screen_size=self._size_threshold(),
            percent_dense=cfg.percent_dense)
        # in place: the captured step reads these tensors
        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(new[k])
            for v in self.stats.values():
                v.zero_()
            self.alive.copy_(new_alive)
        self._surgery(touched | (old_alive != new_alive))
        out = dict(dstats)
        out["alive_before"] = old_alive.sum()
        out["num_alive"] = new_alive.sum()
        return out

    def _densify_event_host(self) -> Dict:
        """The numpy reference path (``densify_and_prune_np`` on the
        trainer's numpy generator), as the JAX trainer's host_densify."""
        cfg = self.cfg
        # copies: on the CPU .numpy() would share the tensors' memory
        alive_np = self.alive.cpu().numpy().copy()
        g_np = {k: p.detach().cpu().numpy().copy() for k, p in self.params.items()}
        g_np["alive"] = alive_np
        state = DensifyState(*(self.stats[k].cpu().numpy()
                               for k in ("grad_accum", "denom", "max_radii")))
        g_np, _, dstats = densify_and_prune_np(
            g_np, state, self.rng, max_grad=cfg.densify_grad_threshold,
            min_opacity=cfg.min_opacity, extent=self.extent,
            max_screen_size=self._size_threshold(),
            percent_dense=cfg.percent_dense)
        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(torch.from_numpy(g_np[k]))
            for v in self.stats.values():
                v.zero_()
            self.alive.copy_(torch.from_numpy(g_np["alive"]))
        self._surgery(torch.from_numpy(g_np["alive"] != alive_np).to(self.device))
        dstats["alive_before"] = int(alive_np.sum())
        dstats["num_alive"] = int(g_np["alive"].sum())
        return dstats

    @torch.no_grad()
    def _surgery(self, changed: torch.Tensor, fields=FLOAT_FIELDS) -> None:
        """Zero the Adam moments of the changed slots (the reference's
        optimizer-state surgery, gaussian_model.py:375-445)."""
        for k in fields:
            state = self.opt.state.get(self.params[k], {})
            for m in ("exp_avg", "exp_avg_sq"):
                if m in state:
                    mask = changed.reshape((-1,) + (1,) * (state[m].dim() - 1))
                    state[m].masked_fill_(mask, 0.0)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def render_view(self, cam_idx: int, bg: Optional[torch.Tensor] = None):
        return self._render(cam_idx, self._background() if bg is None else bg)

    def gaussians_np(self) -> Dict[str, np.ndarray]:
        out = {k: p.detach().cpu().numpy() for k, p in self.params.items()}
        out["alive"] = self.alive.cpu().numpy()
        return out

    # ------------------------------------------------------------------
    def capture(self) -> Dict:
        """The resumable state as numpy: params, per field the Adam moments
        and step count, the densification stats, alive and the step.  The
        camera generator is not part of it (nor of the JAX capture)."""
        adam = {}
        for k, p in self.params.items():
            st = self.opt.state.get(p, {})
            adam[k] = {"exp_avg": (st["exp_avg"] if st else torch.zeros_like(p))
                       .cpu().numpy(),
                       "exp_avg_sq": (st["exp_avg_sq"] if st else torch.zeros_like(p))
                       .cpu().numpy(),
                       "step": int(st["step"]) if st else 0}
        return {"params": self.gaussians_np(), "adam": adam,
                "stats": {k: v.cpu().numpy() for k, v in self.stats.items()},
                "alive": self.alive.cpu().numpy(), "step": self.step_count}

    @torch.no_grad()
    def restore(self, tree: Dict) -> None:
        """Load a ``capture()`` (or ``core.convert.trainer_state_from_jax``)
        state: the parameters keep their identity, so the optimizer does.
        A captured step graph is dropped (its Adam state is replaced)."""
        dev = self.device
        step_dev = dev if self.on_card else "cpu"   # capturable Adam's step
        for k, p in self.params.items():
            p.copy_(torch.tensor(np.array(tree["params"][k]), device=dev))
            a = tree["adam"][k]
            self.opt.state[p] = {
                "step": torch.tensor(float(a["step"]), device=step_dev),
                "exp_avg": torch.tensor(np.array(a["exp_avg"]), device=dev),
                "exp_avg_sq": torch.tensor(np.array(a["exp_avg_sq"]), device=dev)}
        for k, v in self.stats.items():
            v.copy_(torch.tensor(np.array(tree["stats"][k]), dtype=torch.float32))
        self.alive.copy_(torch.tensor(np.array(tree["alive"])))
        self.step_count = int(tree["step"])
        self._graph = None

    def save(self, path: str) -> None:
        """``capture()`` as one .npz (``core.checkpoint.save_trainer_state``)."""
        from v3d_tpu_torch.core.checkpoint import save_trainer_state

        save_trainer_state(path, self.capture())

    def load(self, path: str) -> None:
        from v3d_tpu_torch.core.checkpoint import load_trainer_state

        self.restore(load_trainer_state(path))
