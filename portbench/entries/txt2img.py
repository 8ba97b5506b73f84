"""Text-to-image through the port's ``ImageDiffusionEngine``: ``sample`` of a
batch of images under CFG, then ``decode``, the images brought to the host
as uint8, as a user receives them.

Each request's context and negative context ((batch, tokens, dim), standing
for the text encoder's output) and its initial noise are drawn on the
device from (seed, request index).

Correctness (``check``), for one finished request drawn from the seed, the
reference following the program step by step from its own state:
``denoise``, at the steps drawn from the seed (the first and the last among
them), the denoiser's output on its CFG-doubled input against the
reference's; ``step``, the sampler's own arithmetic (vanilla CFG and the
Euler update): the guided denoised value the program's step implies
(``bench.recorder.euler_guided``) against the reference's guidance of its
denoiser's output; ``decode``, the images against the reference's decode of
the program's final latents.  Each is the relative RMS gap
(``bench.compare.rel_gap``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.bench.compare import rel_gap
from portbench.bench.recorder import DenoiserRecorder, checked_calls, euler_guided
from portbench.bench.seeded import generator
from portbench.reference.numerics import Numerics, float32_exact
from portbench.reference.pipelines import ddpm_sigmas


class Entry:
    unit = "request"

    def __init__(self, cell, seed: int, device):
        self.cfg, self.seed, self.dev = cell.config, seed, torch.device(device)
        self.p = cell.traffic["params"]
        self.mod = cell.config_module
        self.engine = self.mod.build_port(self.cfg, "serve", self.dev, seed, sampler=self.p)
        self.rec = DenoiserRecorder(self.engine.denoiser, checked_calls(
            seed, self.p["num_steps"], self.p["checked_steps"]))
        self.engine.denoiser = self.rec
        self.done: List[Dict] = []

    def inputs(self, i: int):
        p, te = self.p, self.cfg["text_encoder"]
        gen = generator(self.dev, self.seed, "request", i)
        n, hw = p["batch"], p["resolution"] // 8
        ctx = torch.randn((n, te["context_tokens"], te["context_dim"]), generator=gen,
                          device=self.dev)
        neg = torch.randn((n, te["context_tokens"], te["context_dim"]), generator=gen,
                          device=self.dev)
        noise = torch.randn((n, hw, hw, 4), generator=gen, device=self.dev)
        return ctx, neg, noise

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _request(self, i: int, keep: bool) -> Dict:
        p = self.p
        t0 = time.perf_counter()
        ctx, neg, noise = self.inputs(i)
        self.rec.reset()
        z = self.engine.sample({"crossattn": ctx}, {"crossattn": neg}, batch=p["batch"],
                               height=p["resolution"], width=p["resolution"], noise=noise)
        self._sync()
        t1 = time.perf_counter()
        images = self.engine.decode(z)
        images = torch.round(images * 255.0).to(torch.uint8).cpu().numpy()
        t2 = time.perf_counter()
        if keep:
            self.done.append({"index": i, "images": images, "z": z.cpu(),
                              "steps": self.rec.taken()[1]})
        return {"sample_s": t1 - t0, "decode_s": t2 - t1, "wall_s": t2 - t0,
                "forwards": self.rec.calls}

    def warmup(self) -> None:
        """One request at the cell's shapes with the sampler cut to
        ``warmup_steps`` steps: every kernel and shape a request runs."""
        full = self.engine.sampler
        self.engine.sampler = dataclasses.replace(full, num_steps=self.p["warmup_steps"])
        try:
            self._request(-1, keep=False)
        finally:
            self.engine.sampler = full

    def run_unit(self, i: int) -> Dict:
        return self._request(i, keep=True)

    def after_window(self) -> None:
        """Nothing: the check reads requests of the window itself."""

    def profiled(self) -> int:
        self._request(-2, keep=False)
        return 1

    def end_to_end(self, window_s: float, stages) -> Dict:
        return {"gen_s": window_s / len(stages)}

    def release(self) -> None:
        self.engine = self.rec = None

    def work(self) -> Dict:
        from portbench.bench.work import model_work

        cfg, p = self.cfg, self.p
        ref = self.mod.build_reference(cfg, "serve", "meta", self.seed)
        n, hw, te = p["batch"], p["resolution"] // 8, cfg["text_encoder"]
        meta = torch.device("meta")
        unet = model_work(lambda: ref.unet(
            torch.empty(2 * n, cfg["network"]["in_channels"], hw, hw, device=meta),
            torch.empty(2 * n, device=meta),
            context=torch.empty(2 * n, te["context_tokens"], te["context_dim"], device=meta)),
            ref.unet)
        dec = model_work(lambda: ref.decoder(torch.empty(n, 4, hw, hw, device=meta)),
                         ref.decoder)
        steps = p["num_steps"]
        return {"flops": steps * unet["flops"] + dec["flops"],
                "attention": steps * unet["attention"],
                "group_norm": steps * unet["group_norm"] + dec["group_norm"]}

    @torch.no_grad()
    def check(self, rng: np.random.Generator, numerics: Numerics = None) -> Dict[str, float]:
        req = self.done[int(rng.integers(len(self.done)))]
        with float32_exact():
            ref = self.mod.build_reference(self.cfg, "serve", self.dev, self.seed)
            cand = None if numerics is None else self.mod.build_reference(
                self.cfg, "serve", self.dev, self.seed, numerics=numerics)
            return self._gaps(req, ref, cand)

    def _gaps(self, req, ref, cand) -> Dict[str, float]:
        dev, p = self.dev, self.p
        ctx, neg, _ = self.inputs(req["index"])
        c, uc = {"crossattn": ctx}, {"crossattn": neg}
        sigmas = np.append(ddpm_sigmas(p["num_steps"]), np.float32(0.0))
        implied = euler_guided(req["steps"], req["z"], sigmas)
        denoise = step = 0.0
        for k, (x, sigma, out) in sorted(req["steps"].items()):
            if abs(sigma - float(sigmas[k])) > 1e-6 * max(1.0, float(sigmas[k])):
                raise AssertionError(f"step {k}: sigma {sigma} is not the schedule's {sigmas[k]}")
            rows, s, cnd = ref.cfg_inputs(x.to(dev), sigma, c, uc)
            want = ref.denoise(rows, s, cnd)
            have = out.to(dev) if cand is None else cand.denoise(rows, s, cnd)
            denoise = max(denoise, rel_gap(have, want))
            if k in implied:
                guided = implied[k].to(dev) if cand is None else ref.guide(have, p["cfg"])
                step = max(step, rel_gap(guided, ref.guide(want, p["cfg"])))
        z = req["z"].to(dev)
        want = ref.decode(z)
        if cand is None:
            have = torch.from_numpy(req["images"]).to(dev).float() / 255.0
        else:
            have = torch.round(cand.decode(z) * 255.0) / 255.0
        return {"denoise": denoise, "step": step, "decode": rel_gap(have, want)}
