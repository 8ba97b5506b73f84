"""Text-to-image with FLUX.1 through the port's ``ImageDiffusionEngine``:
``sample`` of one image a row, guidance-distilled (one row a step, the
guidance scale a condition of the network, no CFG), then ``decode``, the
images brought to the host as uint8, as a user receives them.

Each request's T5 context (batch, tokens, 4096) and pooled CLIP vector
(batch, 768), standing for the text encoders' outputs, and its initial
noise are drawn on the device from (seed, request index).

Correctness (``check``), for one finished request drawn from the seed, the
reference following the program step by step from its own state:
``denoise``, at the steps drawn from the seed (the first and the last among
them), the flow denoiser's output x - t v on the program's input against
the reference's; ``step``, the sampler's own arithmetic (the Euler update):
the denoised value the program's step implies (``bench.recorder.
euler_guided``) against the reference's denoiser output; ``decode``, the
images against the reference's decode of the program's final latents.
Each is the relative RMS gap (``bench.compare.rel_gap``).  One reference
is built (47.6 GB in float32 at full size); the control switches its
numerics in place.
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
from portbench.reference.flux import JointAttention
from portbench.reference.numerics import F32, Numerics, float32_exact, set_numerics


class FlowRecorder(DenoiserRecorder):
    """``DenoiserRecorder`` for a sampler with no CFG pair: the kept input
    is the whole batch."""

    def __call__(self, network, x, sigma, cond, **kw):
        out = self.inner(network, x, sigma, cond, **kw)
        if self.calls == 0:
            self.cond = {k: v.detach().clone() for k, v in cond.items()}
        if self.calls in self.calls_kept:
            self.kept[self.calls] = (x.detach().clone(), sigma.flatten()[0].clone(),
                                     out.detach().clone())
        self.calls += 1
        return out


class Entry:
    unit = "request"

    def __init__(self, cell, seed: int, device):
        self.cfg, self.seed, self.dev = cell.config, seed, torch.device(device)
        self.p = cell.traffic["params"]
        self.mod = cell.config_module
        self.engine = self.mod.build_port(self.cfg, "serve", self.dev, seed, sampler=self.p)
        self.rec = FlowRecorder(self.engine.denoiser, checked_calls(
            seed, self.p["num_steps"], self.p["checked_steps"]))
        self.engine.denoiser = self.rec
        self.done: List[Dict] = []

    def inputs(self, i: int):
        """Request i's (cond, noise): T5 tokens, the pooled vector, the
        guidance scale a row; the noise (n, h, w, 16)."""
        p, te, tr = self.p, self.cfg["text_encoders"], self.cfg["transformer"]
        gen = generator(self.dev, self.seed, "request", i)
        n, hw = p["batch"], p["resolution"] // 8
        ctx = torch.randn((n, te["t5_tokens"], tr["joint_attention_dim"]), generator=gen,
                          device=self.dev)
        pooled = torch.randn((n, tr["pooled_projection_dim"]), generator=gen, device=self.dev)
        noise = torch.randn((n, hw, hw, self.cfg["vae"]["latent_channels"]), generator=gen,
                            device=self.dev)
        cond = {"crossattn": ctx, "vector": pooled,
                "guidance": torch.full((n,), float(p["guidance"]), device=self.dev)}
        return cond, noise

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _request(self, i: int, keep: bool) -> Dict:
        p = self.p
        t0 = time.perf_counter()
        cond, noise = self.inputs(i)
        self.rec.reset()
        z = self.engine.sample(cond, None, batch=p["batch"], height=p["resolution"],
                               width=p["resolution"], noise=noise)
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
        """A request's FLOPs (the transformer's forwards and the decode) and
        ``joint_attention``: the (b, heads, sq, sk, d) of each joint
        attention of one forward, counted on the reference on meta."""
        from portbench.bench.work import model_work

        cfg, p = self.cfg, self.p
        ref = self.mod.build_reference(cfg, "serve", "meta", self.seed)
        n, hw, te = p["batch"], p["resolution"] // 8, cfg["text_encoders"]
        tr, z = cfg["transformer"], cfg["vae"]["latent_channels"]
        meta = torch.device("meta")
        sites = []

        def on_attention(mod, args, out):
            b, h, L, d = args[0].shape
            sites.append((b, h, L, L, d))

        hooks = [m.register_forward_hook(on_attention) for m in ref.transformer.modules()
                 if isinstance(m, JointAttention)]
        try:
            fwd = model_work(lambda: ref.transformer(
                torch.empty(n, z, hw, hw, device=meta),
                torch.empty(n, device=meta),
                torch.empty(n, te["t5_tokens"], tr["joint_attention_dim"], device=meta),
                torch.empty(n, tr["pooled_projection_dim"], device=meta),
                torch.empty(n, device=meta)), ref.transformer)
        finally:
            for h in hooks:
                h.remove()
        dec = model_work(lambda: ref.decoder(
            torch.empty(n, z, hw, hw, device=meta)), ref.decoder)
        steps = p["num_steps"]
        return {"flops": steps * fwd["flops"] + dec["flops"], "joint_attention": sites,
                "group_norm": dec["group_norm"]}

    @torch.no_grad()
    def check(self, rng: np.random.Generator, numerics: Numerics = None) -> Dict[str, float]:
        req = self.done[int(rng.integers(len(self.done)))]
        with float32_exact():
            ref = self.mod.build_reference(self.cfg, "serve", self.dev, self.seed)
            return self._gaps(req, ref, numerics)

    def _gaps(self, req, ref, numerics) -> Dict[str, float]:
        """The gaps; with ``numerics`` the reference at that precision stands
        in the program's place (its numerics switched on the one model)."""
        dev, p = self.dev, self.p
        cond, _ = self.inputs(req["index"])
        sigmas = self.mod.reference_sigmas(self.cfg, p["num_steps"], p["resolution"])
        implied = euler_guided(req["steps"], req["z"], sigmas)
        models = (ref.transformer, ref.decoder)

        def as_candidate(fn, *args):
            for m in models:
                set_numerics(m, numerics)
            try:
                return fn(*args)
            finally:
                for m in models:
                    set_numerics(m, F32)

        denoise = step = 0.0
        for k, (x, sigma, out) in sorted(req["steps"].items()):
            if abs(sigma - float(sigmas[k])) > 1e-6 * max(1.0, float(sigmas[k])):
                raise AssertionError(f"step {k}: sigma {sigma} is not the schedule's {sigmas[k]}")
            x = x.to(dev)
            s = torch.full((x.shape[0],), float(sigma), device=dev)
            want = ref.denoise(x, s, cond)
            have = out.to(dev) if numerics is None else as_candidate(ref.denoise, x, s, cond)
            denoise = max(denoise, rel_gap(have, want))
            if k in implied:
                got = implied[k].to(dev) if numerics is None else have
                step = max(step, rel_gap(got, want))
        z = req["z"].to(dev)
        want = ref.decode(z)
        if numerics is None:
            have = torch.from_numpy(req["images"]).to(dev).float() / 255.0
        else:
            have = torch.round(as_candidate(ref.decode, z) * 255.0) / 255.0
        return {"denoise": denoise, "step": step, "decode": rel_gap(have, want)}
