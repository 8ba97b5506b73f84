"""Fine-tuning steps of the port's ``DiffusionTrainer``, back to back, as
``apps.train_diffusion.train`` drives them: each step's batch through
``apps.train_diffusion.prepare_batch`` (the device stage), then
``train_step``.

Step i's batch is drawn on the device from (seed, i): the videos' latents,
each video's front view with its cond-aug noise, its CLIP embedding, the
per-frame scalars, and the step's draws (per-frame log-normal sigmas, the
noise), which ``train_step`` takes as given.

Set-up builds one trainer and drives it through its first
``checked_steps`` steps with that same call and feed; they are the
correctness check's and the warm-up.  The reference (float32, its own AdamW
and EMA, the same weights and batches) follows them after the window:
- ``loss``: each step's loss;
- ``grad``: each leaf's first gradient as the optimizer got it (the port's
  from AdamW's first moment after one step, m = (1 - beta1) g);
- ``update``: each leaf's change over the checked steps;
- ``ema``: each leaf's EMA change over them;
the leaf gaps by ``bench.compare.leaf_gap``, the loss by ``loss_gap``.

After the window the same trainer takes one more step through the same
call (``after_window``), the state it starts from (parameters, AdamW's
moments and count, the EMA) copied to the host first.  The reference
follows that step from that state: ``window_loss``, ``window_update`` and
``window_ema`` (each leaf's change in the step), as above.  So a path that
the trainer takes only after its first steps is compared too.  (Its
gradient is not: by then the median leaf's gradient has fallen a
hundredfold, and neither the worst leaf's gap, a one-element mix factor's
round-off, nor the median leaf's separates sound runs from the control.)
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.bench.compare import leaf_gap, loss_gap
from portbench.bench.seeded import generator, seed_for, seeded_values
from portbench.reference.numerics import Numerics, float32_exact, set_numerics
from portbench.reference.pipelines import AdamWEMA, lambda_linear_lr

BETA1 = 0.9   # AdamW's, in both the port's trainer and the reference


class Entry:
    unit = "step"

    def __init__(self, cell, seed: int, device):
        from v3d_tpu_torch.engines.trainer import DiffusionTrainer, TrainConfig

        self.cfg, self.seed, self.dev = cell.config, seed, torch.device(device)
        self.p = cell.traffic["params"]
        self.mod = cell.config_module
        tc = self.cfg["train"]
        engine = self.mod.build_port(self.cfg, "train", self.dev, seed)
        self.trainer = DiffusionTrainer(
            engine, TrainConfig(base_learning_rate=tc["lr"], weight_decay=tc["weight_decay"],
                                ema_decay=tc["ema_decay"], log_every=1 << 30,
                                ckpt_every=1 << 30),
            num_frames=self.cfg["num_frames"], seed=seed)
        self.step_i = 0
        self.losses: List[float] = []
        self.grad: Dict[str, float] = {}
        self.update: Dict[str, float] = {}
        self.ema: Dict[str, float] = {}
        self.window: Dict = None          # the state before the step after the window
        self.window_got: Dict = None

    # -- inputs --
    def batch(self, i: int) -> Dict[str, torch.Tensor]:
        """Step i's raw batch and draws, on the device."""
        p, cfg = self.p, self.cfg
        t, b, hw = cfg["num_frames"], p["videos"], p["latent_hw"]
        gen = generator(self.dev, self.seed, "batch", i)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=self.dev)

        latents = randn(b * t, hw, hw, 4)
        ones = torch.ones((b * t,), device=self.dev)
        loss = cfg["loss"]
        return {
            "latents": latents,
            "cond_frames": latents[::t] + p["cond_aug"] * randn(b, hw, hw, 4),
            "cond_frames_without_noise": randn(b, 1, cfg["network"]["context_dim"]),
            "fps_id": ones * p["fps_id"], "motion_bucket_id": ones * p["motion_bucket_id"],
            "cond_aug": ones * p["cond_aug"],
            "sigmas": torch.exp(loss["p_mean"] + loss["p_std"] * randn(b * t)),
            "noise": randn(b * t, hw, hw, 4)}

    def _step(self) -> float:
        from v3d_tpu_torch.apps.train_diffusion import prepare_batch

        raw = self.batch(self.step_i)
        prepared = prepare_batch(self.trainer.engine, {k: v for k, v in raw.items()
                                                       if k not in ("sigmas", "noise")},
                                 self.cfg["num_frames"])
        stats = self.trainer.train_step(prepared["latents"], prepared["cond"],
                                        sigmas=raw["sigmas"], noise=raw["noise"])
        self.step_i += 1
        return stats["loss"]

    def _leaf_norms(self, tensors) -> Dict[str, float]:
        return {n: float(t.float().norm()) for n, t in zip(self.trainer.names, tensors)}

    @torch.no_grad()
    def _changes(self, tensors) -> Dict[str, float]:
        """Each leaf's norm of change from its seeded start."""
        start = seeded_values(self.trainer.unet, seed_for(self.seed, "weights", "unet"),
                              self.dev)
        now = dict(zip(self.trainer.names, tensors))
        return {name: float((now[name].float() - vals).norm()) for name, _, vals in start}

    def warmup(self) -> None:
        """The checked steps: the first one's gradients, every loss, and the
        parameters' and the EMA's change after the last."""
        opt = self.trainer.opt
        for k in range(self.p["checked_steps"]):
            self.losses.append(self._step())
            if k == 0:
                self.grad = self._leaf_norms(
                    [opt.state[p]["exp_avg"] / (1 - BETA1) for p in self.trainer.params])
        self.update = self._changes(self.trainer.params)
        self.ema = self._changes(self.trainer.ema)

    def after_window(self) -> None:
        """One more step through the window's call, its starting state kept
        on the host for the reference; its loss and changes."""
        tr = self.trainer
        state = [tr.opt.state[p] for p in tr.params]

        def host(tensors):
            return {n: t.detach().to("cpu", copy=True) for n, t in zip(tr.names, tensors)}

        self.window = {"batch": self.step_i, "step": tr.step, "params": host(tr.params),
                       "m": host(s["exp_avg"] for s in state),
                       "v": host(s["exp_avg_sq"] for s in state), "ema": host(tr.ema)}
        w = self.window
        loss = self._step()

        @torch.no_grad()
        def changes(now, before):
            return {n: float((a.float() - before[n].to(a.device)).norm())
                    for n, a in zip(tr.names, now)}

        self.window_got = {"losses": [loss], "update": changes(tr.params, w["params"]),
                           "ema": changes(tr.ema, w["ema"])}

    def run_unit(self, i: int) -> Dict:
        t0 = time.perf_counter()
        self._step()
        return {"step_s": time.perf_counter() - t0}

    def profiled(self) -> int:
        self._step()
        self._step()
        return 2

    def end_to_end(self, window_s: float, stages) -> Dict:
        return {"train_step_ms": 1e3 * window_s / len(stages)}

    def release(self) -> None:
        self.trainer = None

    def work(self) -> Dict:
        """One step's forward, counted on the reference at the step's rows."""
        from portbench.bench.work import model_work

        cfg, p = self.cfg, self.p
        ref = self.mod.build_reference(cfg, "train", "meta", self.seed, modules=("unet",))
        t, rows, hw = cfg["num_frames"], cfg["num_frames"] * p["videos"], p["latent_hw"]
        meta = torch.device("meta")
        net = cfg["network"]
        return model_work(lambda: ref.unet(
            torch.empty(rows, net["in_channels"], hw, hw, device=meta),
            torch.empty(rows, device=meta),
            context=torch.empty(rows, 1, net["context_dim"], device=meta),
            y=torch.empty(rows, net["adm_in_channels"], device=meta), num_video_frames=t,
            image_only_indicator=torch.zeros(rows // t, t, device=meta)), ref.unet)

    # -- correctness --
    def _reference_step(self, pipe, params, k: int) -> Tuple[float, List[torch.Tensor]]:
        """Step k's loss and gradients on the reference."""
        t = self.cfg["num_frames"]
        raw = self.batch(k)
        cond = pipe.training_cond(raw)
        total = 0.0
        for v in range(self.p["videos"]):
            rows = slice(v * t, (v + 1) * t)
            loss = pipe.loss(raw["latents"][rows], {c: x[rows] for c, x in cond.items()},
                             raw["sigmas"][rows], raw["noise"][rows]) / self.p["videos"]
            loss.backward()
            total += float(loss.detach())
        grads = [p.grad for p in params]
        return total, grads

    def reference_steps(self, numerics: Numerics = None) -> Tuple[Dict, Dict]:
        """The checked steps on the reference (or, with ``numerics``, the
        reference at that precision in the program's place): losses, the
        first gradients' and the changes' leaf norms; then the same of the
        step after the window, from the program's state before it."""
        tc = self.cfg["train"]
        pipe = self.mod.build_reference(self.cfg, "train", self.dev, self.seed, modules=("unet",))
        if numerics is not None:
            set_numerics(pipe.unet, numerics)
        names, params = zip(*pipe.unet.named_parameters())
        for p in params:
            p.requires_grad_(True)

        def step(opt, k, out):
            loss, grads = self._reference_step(pipe, params, k)
            if "grad" not in out:
                out["grad"] = {n: float(g.norm()) for n, g in zip(names, grads)}
            opt.step(grads, lambda_linear_lr(tc["lr"], k, tc["warm_up_steps"], tc["f_start"]))
            for p in params:
                p.grad = None
            out["losses"].append(loss)

        opt = AdamWEMA(list(params), tc["weight_decay"], tc["ema_decay"])
        out = {"losses": []}
        for k in range(self.p["checked_steps"]):
            step(opt, k, out)
        with torch.no_grad():
            start = {n: vals for n, _, vals in seeded_values(
                pipe.unet, seed_for(self.seed, "weights", "unet"), self.dev)}
            out["update"] = {n: float((p - start[n]).norm()) for n, p in zip(names, params)}
            out["ema"] = {n: float((e - start[n]).norm()) for n, e in zip(names, opt.ema)}
            del start
        if self.window is None:
            return out, None

        w = self.window
        with torch.no_grad():
            for n, p in zip(names, params):
                p.copy_(w["params"][n])
        opt = AdamWEMA(list(params), tc["weight_decay"], tc["ema_decay"])
        opt.m, opt.v, opt.ema = ([w[k][n].to(self.dev, copy=True) for n in names]
                                 for k in ("m", "v", "ema"))
        opt.n = w["step"]
        win = {"losses": []}
        step(opt, w["batch"], win)
        with torch.no_grad():
            win["update"] = {n: float((p - w["params"][n].to(p.device)).norm())
                             for n, p in zip(names, params)}
            win["ema"] = {n: float((e - w["ema"][n].to(e.device)).norm())
                          for n, e in zip(names, opt.ema)}
        return out, win

    def check(self, rng: np.random.Generator, numerics: Numerics = None) -> Dict[str, float]:
        with float32_exact():
            ref, ref_w = self.reference_steps()
            if numerics is None:
                got = {"losses": self.losses, "grad": self.grad, "update": self.update,
                       "ema": self.ema}
                got_w = self.window_got
            else:
                got, got_w = self.reference_steps(numerics)
        out = self._gaps(got, ref, ("loss", "grad", "update", "ema"))
        if ref_w is not None:
            out.update(self._gaps(got_w, ref_w, ("loss", "update", "ema"), "window_"))
        return out

    @staticmethod
    def _gaps(got: Dict, ref: Dict, names, prefix: str = "") -> Dict[str, float]:
        g = ref["grad"]
        return {prefix + k: loss_gap(got["losses"], ref["losses"]) if k == "loss"
                else leaf_gap(got[k], ref[k], g) for k in names}
