"""V3D generation through the port's user entry point,
``v3d_tpu_torch.apps.generate.sample_one``, on an engine built once in
set-up.

Each request is an RGBA object image on a transparent background, drawn
with numpy from (seed, request index) at the traffic's size, with its three
standard-normal draws (the VAE sample, the cond-aug noise, the initial
latent) made on the device from the same key and handed to ``sample_one``.

Correctness (``check``), for one finished request drawn from the seed: the
reference follows the program step by step from the program's own state.
- ``cond``: the conditioning the denoiser received (CLIP embedding, the
  noised cond latent, the vector; CFG-doubled) against the reference's,
  worked out from the raw image and the same draws;
- ``denoise``: at the steps drawn from the seed (the first and the last
  among them), the denoiser's output on its CFG-doubled input against the
  reference denoiser's on the same input and its own conditioning;
- ``step``: the sampler's own arithmetic, the per-frame linear CFG and the
  Euler update: the guided denoised value that the program's step implies
  (from a kept step's input to the next one's, and from the last step's to
  the sampler's result; ``bench.recorder.euler_guided``) against the
  reference's guidance of its denoiser's output on the same input;
- ``decode``: the frames against the reference's decode of the program's
  final latents, in the same chunks.
Each is the relative RMS gap, ||program - reference|| / ||reference - its
mean||.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.bench.compare import rel_gap
from portbench.bench.recorder import DenoiserRecorder, checked_calls, euler_guided
from portbench.bench.seeded import generator, seed_for
from portbench.reference.numerics import Numerics, float32_exact
from portbench.reference.pipelines import edm_sigmas, preprocess_rgba


def object_image(seed: int, i: int, size: int, shape: dict) -> np.ndarray:
    """An RGBA object (an ellipse of seeded colour gradients and grain) on a
    transparent background; every draw keeps it inside the frame."""
    rng = np.random.default_rng(seed_for(seed, "image", i))
    yy, xx = np.mgrid[:size, :size] / size
    cy, cx = rng.uniform(*shape["centre"], size=2)
    ay, ax = rng.uniform(*shape["axes"], size=2)
    inside = (yy - cy) ** 2 / ay ** 2 + (xx - cx) ** 2 / ax ** 2 < 1
    base = rng.uniform(60, 200, size=3)
    slope = rng.uniform(-60, 60, size=(2, 3))
    rgb = base + slope[0] * xx[..., None] + slope[1] * yy[..., None]
    rgb = rgb + rng.uniform(0, shape["grain"], size=(size, size, 3))
    img = np.zeros((size, size, 4), np.uint8)
    img[..., :3] = np.clip(rgb, 0, 255).astype(np.uint8)
    img[..., 3] = np.where(inside, 255, 0)
    return img


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
        decode = self.engine.decode_latents

        def recorded_decode(z, decoding_t=None):
            self.z = z.detach().clone()
            return decode(z, decoding_t=decoding_t)

        self.engine.decode_latents = recorded_decode
        self.done: List[Dict] = []

    def inputs(self, i: int):
        size = self.p["image_size"]
        image = object_image(self.seed, i, size, self.p["object"])
        gen = generator(self.dev, self.seed, "request noise", i)
        hw = self.p["resolution"] // 8
        t = self.cfg["num_frames"]
        enc = torch.randn((1, hw, hw, 4), generator=gen, device=self.dev)
        aug = torch.randn((1, hw, hw, 4), generator=gen, device=self.dev)
        noise = torch.randn((t, hw, hw, 4), generator=gen, device=self.dev)
        return image, enc, aug, noise

    def _request(self, i: int, keep: bool) -> Dict:
        from v3d_tpu_torch.apps.generate import sample_one

        p = self.p
        t0 = time.perf_counter()
        image, enc, aug, noise = self.inputs(i)
        self.rec.reset()
        frames, _, timings = sample_one(
            image, engine=self.engine, num_frames=self.cfg["num_frames"],
            num_steps=p["num_steps"], fps_id=p["fps_id"],
            motion_bucket_id=p["motion_bucket_id"], cond_aug=p["cond_aug"],
            decoding_t=p["decoding_t"], border_ratio=p["border_ratio"],
            min_guidance_scale=p["min_cfg"], max_guidance_scale=p["max_cfg"],
            sigma_max=self.cfg["schedule"]["sigma_max"], device=self.dev,
            resolution=p["resolution"], enc_noise=enc, aug_noise=aug, noise=noise)
        wall = time.perf_counter() - t0
        if keep:
            cond, steps = self.rec.taken()
            self.done.append({"index": i, "frames": frames, "cond": cond, "steps": steps,
                              "z": self.z.cpu()})
        return dict(timings, wall_s=wall, forwards=self.rec.calls)

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

    # -- the work of one request, from the reference on the meta device --
    def work(self) -> Dict:
        from portbench.bench.work import model_work

        cfg, p = self.cfg, self.p
        ref = self.mod.build_reference(cfg, "serve", "meta", self.seed)
        t, hw, res = cfg["num_frames"], p["resolution"] // 8, p["resolution"]
        meta = torch.device("meta")
        ctx, vec = torch.empty(2 * t, 1, cfg["network"]["context_dim"], device=meta), \
            torch.empty(2 * t, cfg["network"]["adm_in_channels"], device=meta)
        unet = model_work(lambda: ref.unet(
            torch.empty(2 * t, cfg["network"]["in_channels"], hw, hw, device=meta),
            torch.empty(2 * t, device=meta), context=ctx, y=vec, num_video_frames=t,
            image_only_indicator=torch.zeros(2, t, device=meta)), ref.unet)
        size = cfg["clip"]["image_size"]
        clip = model_work(lambda: ref.clip(torch.empty(1, 3, size, size, device=meta)), ref.clip)
        enc = model_work(lambda: ref.encoder(torch.empty(1, 3, res, res, device=meta)),
                         ref.encoder)
        dt = p["decoding_t"]
        dec = model_work(lambda: [ref.decoder(torch.empty(min(dt, t - i), 4, hw, hw, device=meta),
                                              min(dt, t - i)) for i in range(0, t, dt)],
                         ref.decoder)
        n = p["num_steps"]
        return {"flops": n * unet["flops"] + clip["flops"] + enc["flops"] + dec["flops"],
                "attention": n * unet["attention"] + clip["attention"],
                "group_norm": n * unet["group_norm"] + enc["group_norm"] + dec["group_norm"]}

    # -- correctness --
    @torch.no_grad()
    def check(self, rng: np.random.Generator, numerics: Numerics = None) -> Dict[str, float]:
        """The three gaps of one finished request drawn from ``rng`` (for the
        program, or with ``numerics`` for the reference computed at that
        precision in the program's place)."""
        req = self.done[int(rng.integers(len(self.done)))]
        with float32_exact():
            ref = self.mod.build_reference(self.cfg, "serve", self.dev, self.seed)
            cand = None if numerics is None else self.mod.build_reference(
                self.cfg, "serve", self.dev, self.seed, numerics=numerics)
            return self._gaps(req, ref, cand)

    def _gaps(self, req, ref, cand) -> Dict[str, float]:
        p, dev = self.p, self.dev
        image, enc, aug, _ = self.inputs(req["index"])
        img = torch.from_numpy(preprocess_rgba(image, p["border_ratio"], p["resolution"]))[None]

        def conditioning(pipe):
            clip_emb, z0 = pipe.encode_image(img.to(dev), p["cond_aug"], enc, aug)
            return pipe.build_cond(clip_emb, z0, p["fps_id"], p["motion_bucket_id"],
                                   p["cond_aug"])

        c, uc = conditioning(ref)
        doubled = {k: torch.cat([uc[k], c[k]]) for k in c}
        if cand is None:
            got = req["cond"]
        else:
            cc, cuc = conditioning(cand)
            got = {k: torch.cat([cuc[k], cc[k]]) for k in cc}
        cond = max(rel_gap(got[k].to(dev), doubled[k]) for k in doubled)

        sigmas = edm_sigmas(p["num_steps"], self.cfg["schedule"]["sigma_min"],
                            self.cfg["schedule"]["sigma_max"], self.cfg["schedule"]["rho"])
        scales = np.linspace(p["min_cfg"], p["max_cfg"], self.cfg["num_frames"])
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
                guided = implied[k].to(dev) if cand is None else ref.guide(have, scales)
                step = max(step, rel_gap(guided, ref.guide(want, scales)))
        z = req["z"].to(dev)
        want = ref.decode(z, p["decoding_t"])
        if cand is None:
            have = torch.from_numpy(req["frames"]).to(dev).float() / 255.0
        else:
            have = torch.round(cand.decode(z, p["decoding_t"]) * 255.0) / 255.0
        return {"cond": cond, "denoise": denoise, "step": step, "decode": rel_gap(have, want)}
