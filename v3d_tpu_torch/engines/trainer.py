"""Diffusion fine-tuning loop (counterpart of v3d_tpu/engines/trainer.py).

One device: AdamW with the LambdaLinear schedule (optax.adamw's math:
torch.optim.AdamW at the same betas, eps and decoupled weight decay, the
rate set per step), optional clipping by the global gradient norm as
optax.clip_by_global_norm, EMA shadow parameters, and checkpoints that a
restarted process resumes from.

Elastic resume: the noise of step N comes from a generator seeded from
(base seed, N), never from a chain of draws, so a run restored at step N
continues with the draws the uninterrupted run would have made
(trainer.py:103-135, the JAX package's ``fold_in(base, step)``).

Data parallel (``mesh``, trainer.py:49-66, :87-127): the parameters are
broadcast from the mesh's first rank at construction; each rank steps on
its slice of the batch's (b t) frames along "data"
(``parallel.mesh.shard_batch``, as the JAX ``shard_batch`` splits them;
the ranks must divide the frames), its draws its rows of the step's draws
at the global batch's shape (the loss's ``block``), and after the backward
one all_reduce on a flat buffer averages the gradients (and the loss) over
"data".  Where a rank's frames are not whole videos, the UNet forward is
frame-parallel (``parallel/frames.py``): the collectives inside it have
differentiable backwards, so the averaged gradients are one process's.
Every rank then clips, steps and updates its EMA exactly as one process
would on the global batch.  The parameters are replicated over "model" as
well, as the JAX trainer replicates them (trainer.py:66-67): handed a UNet
that ``parallel.tensor.tp_shard_`` cut, the trainer makes it whole again
(``tp_unshard_``, the counterpart of ``device_put(..., P())``).  No
DDP wrapper: the parameters keep the names that checkpoints and the key
maps use.  With no mesh the same step runs as on a (1, 1) mesh, with no
collective.
"""

from __future__ import annotations

import dataclasses
import os
import re
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from v3d_tpu_torch.data.prefetch import device_prefetch
from v3d_tpu_torch.engines.ema import ema_init, ema_update_
from v3d_tpu_torch.engines.lr_schedule import lambda_linear
from v3d_tpu_torch.parallel.mesh import (
    all_reduce_mean_,
    barrier,
    data_block,
    is_first_rank,
    mesh_device,
    replicate,
    shard_batch,
)
from v3d_tpu_torch.parallel.tensor import tp_unshard_
from v3d_tpu_torch.utils.trace import span

_CKPT = re.compile(r"step_(\d+)\.pt$")


@dataclasses.dataclass
class TrainConfig:
    base_learning_rate: float = 1e-4     # V3D_512.yaml model.base_learning_rate
    weight_decay: float = 0.0
    ema_decay: float = 0.9999
    use_ema: bool = True
    max_steps: int = 100_000
    log_every: int = 100
    ckpt_every: int = 5000
    ckpt_dir: Optional[str] = None
    keep_last: int = 3
    grad_clip: Optional[float] = None


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step``: seeded from (seed, step) alone."""
    state = int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(state)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The highest-step ``<ckpt_dir>/step_<N>.pt``, or None.  A save in
    progress has another name until it is complete (``save``)."""
    if not ckpt_dir or not os.path.isdir(ckpt_dir):
        return None
    found = [(int(m.group(1)), name) for name in os.listdir(ckpt_dir)
             if (m := _CKPT.fullmatch(name))]
    return os.path.join(ckpt_dir, max(found)[1]) if found else None


def prune_checkpoints(ckpt_dir: str, keep: int) -> None:
    """Keep the ``keep`` newest step checkpoints, delete the rest."""
    if keep <= 0 or not os.path.isdir(ckpt_dir):
        return
    found = sorted((int(m.group(1)), name) for name in os.listdir(ckpt_dir)
                   if (m := _CKPT.fullmatch(name)))
    for _, name in found[:-keep]:
        os.remove(os.path.join(ckpt_dir, name))


class DiffusionTrainer:
    """Trains the engine's VideoUNet with its EDM loss on pre-encoded latent
    batches (input_key 'latents', V3D_512.yaml)."""

    def __init__(self, engine, config: TrainConfig = TrainConfig(),
                 num_frames: Optional[int] = None, seed: int = 0, mesh=None):
        self.engine = engine
        self.cfg = config
        self.t = num_frames or engine.num_frames
        self.seed = seed
        self.mesh = mesh
        self.unet = tp_unshard_(engine.unet).train().requires_grad_(True)
        self.names, self.params = zip(*self.unet.named_parameters())
        if mesh is not None:
            dev = mesh_device(mesh)
            away = [(n, p.device) for n, p in zip(self.names, self.params)
                    if p.device != dev]
            if away:
                raise ValueError(f"DiffusionTrainer: {away[0][0]} is on {away[0][1]}, "
                                 f"this rank's mesh device is {dev} (set_device first)")
            replicate(self.params, mesh)      # in place: overwritten by the first rank's
        self.schedule = lambda_linear()
        self.opt = torch.optim.AdamW(
            self.params, lr=config.base_learning_rate, betas=(0.9, 0.999),
            eps=1e-8, weight_decay=config.weight_decay)
        self.ema = ema_init(self.params) if config.use_ema else None
        self.step = 0

    @property
    def device(self) -> torch.device:
        return self.params[0].device

    def train_step(self, latents: torch.Tensor, cond: Dict,
                   sigmas: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None) -> Dict:
        """One AdamW step on ((b t), h, w, 4) latents (under a mesh, this
        rank's slice); the draws come from this step's generator at the
        global batch's shape unless ``sigmas`` / ``noise`` (the global
        batch's) are given.  The loss and gradient norm returned are the
        global batch's."""
        with span("trainer.step", step=self.step):
            for group in self.opt.param_groups:
                group["lr"] = self.cfg.base_learning_rate * self.schedule(self.step)
            self.opt.zero_grad(set_to_none=True)
            with span("trainer.forward"):
                loss = self.engine.training_loss(
                    latents, cond, num_frames=self.t, sigmas=sigmas, noise=noise,
                    generator=step_generator(self.seed, self.step, latents.device),
                    block=data_block(self.mesh), mesh=self.mesh)
            with span("trainer.backward"):
                loss.backward()
            with span("trainer.update"):
                grads = [p.grad for p in self.params if p.grad is not None]
                loss = loss.detach().reshape(1).clone()
                if self.mesh is not None:
                    with span("trainer.all_reduce"):
                        all_reduce_mean_(grads + [loss], self.mesh)
                gnorm = torch.nn.utils.get_total_norm(grads)
                if self.cfg.grad_clip and float(gnorm) >= self.cfg.grad_clip:
                    torch._foreach_mul_(grads, self.cfg.grad_clip / gnorm)
                with span("trainer.optimizer"):
                    self.opt.step()
                if self.ema is not None:
                    with span("trainer.ema"):
                        ema_update_(self.ema, self.params, self.step, self.cfg.ema_decay)
            self.step += 1
            with span("trainer.sync"):
                return {"loss": float(loss), "grad_norm": float(gnorm), "step": self.step}

    def shard_batch(self, batch: Dict) -> Dict:
        """This rank's slice of a global batch along "data" (the batch as
        it is without a mesh)."""
        return batch if self.mesh is None else shard_batch(batch, self.mesh)

    def fit(self, data_iter: Iterator[Dict], max_steps: Optional[int] = None,
            log_fn: Callable[[Dict], None] = print,
            auto_resume: bool = True, prefetch: bool = False,
            put_fn: Optional[Callable[[Dict], Dict]] = None) -> None:
        """Train on ``{"latents", "cond"}`` batches until ``max_steps``; with
        ``auto_resume`` a restarted process first restores the newest
        checkpoint in ``ckpt_dir``.  The data iterator's position is the
        caller's (a stateless or seeded stream).  ``put_fn`` maps each batch
        before its step; by default ``shard_batch`` cuts a global batch to
        this rank's slice (an iterator of batches that are this rank's
        already passes an identity).  Only the mesh's first rank logs.

        ``prefetch`` (trainer.py:116-121): ``data_iter`` (host batches) is
        iterated in a background thread, ``put_fn`` applied there, and each
        batch copied to this trainer's device one step ahead
        (``data.prefetch.device_prefetch``), so that thread must do host
        work only.  ``apps.train_diffusion.batches`` prefetches its host
        stage itself, ahead of its device stage."""
        max_steps = max_steps or self.cfg.max_steps
        if auto_resume and self.cfg.ckpt_dir and self.step == 0:
            self.resume_latest()
        put_fn = put_fn or self.shard_batch
        if prefetch:
            data_iter = device_prefetch(data_iter, put_fn=put_fn, device=self.device)
        else:
            data_iter = map(put_fn, data_iter)
        first = is_first_rank(self.mesh)     # logs and prunes
        t0 = time.perf_counter()
        try:
            while self.step < max_steps:
                # no batch is drawn past the last step: a batch's device
                # stage (``train_diffusion.batches``) runs as it is drawn
                batch = next(data_iter, None)
                if batch is None:
                    break
                stats = self.train_step(batch["latents"], batch["cond"])
                if self.step % self.cfg.log_every == 0:
                    stats["steps_per_sec"] = self.cfg.log_every / (time.perf_counter() - t0)
                    t0 = time.perf_counter()
                    if first:
                        log_fn(stats)
                if self.cfg.ckpt_dir and self.step % self.cfg.ckpt_every == 0:
                    self.save(os.path.join(self.cfg.ckpt_dir, f"step_{self.step}.pt"))
                    if first:
                        prune_checkpoints(self.cfg.ckpt_dir, self.cfg.keep_last)
        finally:
            if prefetch:
                data_iter.close()

    def state_dict(self) -> Dict:
        state = {"params": self.unet.state_dict(), "opt_state": self.opt.state_dict(),
                 "step": self.step}
        if self.ema is not None:
            state["ema_params"] = dict(zip(self.names, self.ema))
        return state

    def save(self, path: str) -> None:
        """torch.save of params, optimizer state, EMA and step, written under
        a temporary name and renamed, so a partial save is never loaded.
        Under a mesh every rank calls it: the first rank writes, the others
        wait for it."""
        if is_first_rank(self.mesh):
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = f"{path}.tmp-{os.getpid()}"
            torch.save(self.state_dict(), tmp)
            os.replace(tmp, path)
        barrier(self.mesh)

    @torch.no_grad()
    def restore(self, path: str) -> None:
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.unet.load_state_dict(state["params"])
        self.opt.load_state_dict(state["opt_state"])
        if self.ema is not None:
            for name, shadow in zip(self.names, self.ema):
                shadow.copy_(state["ema_params"][name])
        self.step = int(state["step"])

    def resume_latest(self) -> bool:
        """Restore the newest complete checkpoint in cfg.ckpt_dir, if any."""
        path = latest_checkpoint(self.cfg.ckpt_dir)
        if path is None:
            return False
        self.restore(path)
        return True
