"""The reference pipelines around the models: image preprocessing, V3D's
conditioning, the EDM and discrete denoisers with their scalings, the
schedules, Euler with per-frame linear and vanilla CFG, the temporal and
image decodes, the EDM training loss, AdamW and the EMA.  A frozen copy of
what ``v3d_tpu_torch`` computes there (``data/preprocess.py``,
``engines/video_diffusion.py``, ``engines/image_diffusion.py``,
``diffusion/``, ``engines/trainer.py``, ``engines/ema.py``), written as
plain float32 formulas; it imports nothing of the port.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from portbench.reference.clip import clip_preprocess
from portbench.reference.layers import timestep_embedding
from portbench.reference.vae import gaussian_sample


# -- preprocessing: matte from alpha, recenter, composite on white, resize ---

def _area_taps(n_in: int, n_out: int, average: bool):
    inv = n_out / n_in
    scale = 1.0 / inv
    if average:
        rows = []
        for i in range(n_out):
            f1 = i * scale
            f2 = f1 + scale
            cell = min(scale, n_in - f1)
            s1, s2 = int(np.ceil(f1)), int(np.floor(f2))
            s2 = min(s2, n_in - 1)
            s1 = min(s1, s2)
            taps = []
            if s1 - f1 > 1e-3:
                taps.append((s1 - 1, (s1 - f1) / cell))
            taps += [(s, 1.0 / cell) for s in range(s1, s2)]
            if f2 - s2 > 1e-3:
                taps.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
            rows.append(taps)
        k = max(len(r) for r in rows)
        idx = np.zeros((n_out, k), np.int64)
        wts = np.zeros((n_out, k), np.float64)
        for i, taps in enumerate(rows):
            for j, (s, w) in enumerate(taps):
                idx[i, j], wts[i, j] = s, w
        return idx, wts
    d = np.arange(n_out)
    sx = np.floor(d * scale).astype(np.int64)
    fx = ((d + 1) - (sx + 1) * inv).astype(np.float32).astype(np.float64)
    fx = np.where(fx <= 0, 0.0, fx - np.floor(fx))
    fx = np.where(sx >= n_in - 1, 0.0, fx)
    return (np.stack([sx, np.minimum(sx + 1, n_in - 1)], 1), np.stack([1 - fx, fx], 1))


def _linear_taps(n_in: int, n_out: int):
    x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    sx = np.floor(x).astype(np.int64)
    fx = x - sx
    fx = np.where((sx < 0) | (sx >= n_in - 1), 0.0, fx)
    sx = np.clip(sx, 0, n_in - 1)
    return np.stack([sx, np.minimum(sx + 1, n_in - 1)], 1), np.stack([1 - fx, fx], 1)


def _apply_taps(x: np.ndarray, axis: int, taps) -> np.ndarray:
    idx, wts = taps
    shape = (-1,) + (1,) * (x.ndim - axis - 1)
    out = 0.0
    for j in range(idx.shape[1]):
        out = out + np.take(x, idx[:, j], axis=axis) * wts[:, j].reshape(shape)
    return out


def _area_resize(x: np.ndarray, h: int, w: int) -> np.ndarray:
    average = x.shape[0] >= h and x.shape[1] >= w
    y = _apply_taps(_apply_taps(x.astype(np.float64), 1, _area_taps(x.shape[1], w, average)),
                    0, _area_taps(x.shape[0], h, average))
    return np.clip(np.rint(y), 0, 255).astype(np.uint8)


def _linear_resize(x: np.ndarray, h: int, w: int) -> np.ndarray:
    y = _apply_taps(_apply_taps(x.astype(np.float64), 1, _linear_taps(x.shape[1], w)), 0,
                    _linear_taps(x.shape[0], h))
    return y.astype(np.float32)


def _recenter(image: np.ndarray, mask: np.ndarray, border_ratio: float) -> np.ndarray:
    H, W = image.shape[:2]
    C = image.shape[2]
    size = max(H, W)
    coords = np.nonzero(mask)
    if len(coords[0]) == 0:
        return image
    x_min, x_max = coords[0].min(), coords[0].max()
    y_min, y_max = coords[1].min(), coords[1].max()
    h, w = x_max - x_min, y_max - y_min
    if h == 0 or w == 0:
        return image
    desired = int(size * (1 - border_ratio))
    scale = desired / max(h, w)
    h2, w2 = int(h * scale), int(w * scale)
    x2, y2 = (size - h2) // 2, (size - w2) // 2
    result = np.zeros((size, size, C), dtype=image.dtype)
    result[x2:x2 + h2, y2:y2 + w2] = _area_resize(
        image[x_min:x_max, y_min:y_max], h2, w2).reshape(h2, w2, C)
    return result


def preprocess_rgba(image: np.ndarray, border_ratio: float, resolution: int) -> np.ndarray:
    """(H, W, 4) uint8 with its own alpha -> (res, res, 3) float32 in
    [-1, 1]: recentred with a border, composited on white, resized."""
    image = _recenter(image, image[..., -1] > 0, border_ratio)
    imf = image.astype(np.float32) / 255.0
    imf = imf[..., :3] * imf[..., 3:4] + (1 - imf[..., 3:4])
    return _linear_resize(imf, resolution, resolution) * 2.0 - 1.0


# -- schedules and denoisers --------------------------------------------------

def edm_sigmas(n: int, sigma_min: float, sigma_max: float, rho: float = 7.0) -> np.ndarray:
    """The Karras schedule, n levels then 0, float32."""
    ramp = np.linspace(0, 1, n, dtype=np.float64)
    lo, hi = sigma_min ** (1 / rho), sigma_max ** (1 / rho)
    s = ((hi + ramp * (lo - hi)) ** rho).astype(np.float32)
    return np.concatenate([s, np.zeros((1,), np.float32)])


def ddpm_sigmas(n: int, linear_start: float = 0.00085, linear_end: float = 0.012,
                timesteps: int = 1000) -> np.ndarray:
    """The legacy DDPM levels: n of the 1000, largest first, float32."""
    betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, timesteps,
                        dtype=np.float64) ** 2
    ac = np.cumprod(1.0 - betas, axis=0)
    if n < timesteps:
        ac = ac[np.linspace(timesteps - 1, 0, n, endpoint=False).astype(int)[::-1]]
    return (((1 - ac) / ac) ** 0.5)[::-1].astype(np.float32)


def v_scaling(sigma):
    """(c_skip, c_out, c_in) of v-prediction."""
    return 1.0 / (sigma ** 2 + 1.0), -sigma / torch.sqrt(sigma ** 2 + 1.0), \
        1.0 / torch.sqrt(sigma ** 2 + 1.0)


def _bcast(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return s.reshape(s.shape + (1,) * (x.dim() - s.dim()))


class V3DPipeline:
    """V3D-512 around the reference modules: ``encode_image``, ``build_cond``,
    the EDM v-denoiser, Euler with per-frame linear CFG, the temporal decode,
    the EDM loss."""

    def __init__(self, unet, encoder, decoder, clip, num_frames: int,
                 scale_factor: float = 0.18215):
        self.unet, self.encoder, self.decoder, self.clip = unet, encoder, decoder, clip
        self.t = num_frames
        self.scale_factor = scale_factor

    def encode_image(self, image: torch.Tensor, cond_aug: float, enc_noise, aug_noise):
        """image (1, H, W, 3) in [-1, 1] -> (CLIP embedding (1, 1, d), the
        noised cond latent (1, h, w, 4))."""
        clip_emb = self.clip(clip_preprocess(image).permute(0, 3, 1, 2))[:, None, :]
        moments = self.encoder(image.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        z = gaussian_sample(moments, enc_noise.float()) + cond_aug * aug_noise.float()
        return clip_emb, z

    def build_cond(self, clip_emb, cond_frames, fps_id, motion_bucket_id, cond_aug
                   ) -> Tuple[Dict, Dict]:
        """The per-frame (c, uc): crossattn the CLIP embedding, concat the
        cond latent (zeros in uc), vector the three scalars' 256-wide
        sinusoidal embeddings."""
        t = self.t
        ones = torch.ones((t,), device=clip_emb.device)
        vector = torch.cat([timestep_embedding(ones * v, 256)
                            for v in (fps_id, motion_bucket_id, cond_aug)], dim=-1)
        c = {"crossattn": clip_emb.repeat_interleave(t, 0),
             "concat": cond_frames.repeat_interleave(t, 0), "vector": vector}
        uc = {"crossattn": torch.zeros_like(c["crossattn"]),
              "concat": torch.zeros_like(c["concat"]), "vector": vector}
        return c, uc

    def training_cond(self, batch: Dict) -> Dict:
        """The per-frame cond of a training batch: each video's CLIP
        embedding and cond latent repeated over its frames, the per-frame
        scalars' embeddings as the vector."""
        t = self.t
        vector = torch.cat([timestep_embedding(batch[k].float(), 256)
                            for k in ("fps_id", "motion_bucket_id", "cond_aug")], dim=-1)
        return {"crossattn": batch["cond_frames_without_noise"].float().repeat_interleave(t, 0),
                "concat": batch["cond_frames"].float().repeat_interleave(t, 0),
                "vector": vector}

    def denoise(self, x: torch.Tensor, sigma: torch.Tensor, cond: Dict) -> torch.Tensor:
        """D(x, sigma) on (rows, h, w, 4), rows a whole number of videos."""
        c_skip, c_out, c_in = (_bcast(s, x) for s in v_scaling(sigma))
        xin = torch.cat([x * c_in, cond["concat"].float()], dim=-1)
        ind = torch.zeros((x.shape[0] // self.t, self.t), device=x.device)
        out = self.unet(xin.permute(0, 3, 1, 2), 0.25 * torch.log(sigma),
                        context=cond["crossattn"], y=cond["vector"],
                        num_video_frames=self.t, image_only_indicator=ind)
        return out.permute(0, 2, 3, 1) * c_out + x * c_skip

    @staticmethod
    def cfg_inputs(x, sigma: float, c: Dict, uc: Dict):
        rows = torch.cat([x, x])
        s = torch.full((rows.shape[0],), float(sigma), device=x.device)
        return rows, s, {k: torch.cat([uc[k], c[k]]) for k in c}

    def guide(self, denoised, scales: Sequence[float]) -> torch.Tensor:
        x_u, x_c = denoised.chunk(2)
        sc = torch.as_tensor(np.asarray(scales, np.float32), device=x_u.device)
        return x_u + _bcast(sc.repeat(x_u.shape[0] // self.t), x_u) * (x_c - x_u)

    def decode(self, z: torch.Tensor, decoding_t: int) -> torch.Tensor:
        """(t, h, w, 4) latents -> frames (t, H, W, 3) in [0, 1], decoded
        in chunks of ``decoding_t`` frames."""
        outs = []
        for i in range(0, z.shape[0], decoding_t):
            chunk = z[i:i + decoding_t].float() / self.scale_factor
            x = self.decoder(chunk.permute(0, 3, 1, 2), chunk.shape[0])
            outs.append(((x + 1.0) / 2.0).clamp(0.0, 1.0).permute(0, 2, 3, 1))
        return torch.cat(outs)

    def loss(self, latents, cond, sigmas, noise) -> torch.Tensor:
        """The mean EDM loss (v-denoiser, weight (sigma^2 + 1) / sigma^2)."""
        noised = latents + noise * _bcast(sigmas, latents)
        d = self.denoise(noised, sigmas, cond)
        w = _bcast((sigmas ** 2 + 1.0) / sigmas ** 2, latents)
        return (w * (d - latents) ** 2).reshape(latents.shape[0], -1).mean(dim=1).mean()


class ImagePipeline:
    """SD 2.x around the reference modules: the discrete v-denoiser over the
    1000 legacy DDPM levels, Euler with vanilla CFG, the image decode."""

    def __init__(self, unet, decoder, scale_factor: float = 0.18215):
        self.unet, self.decoder, self.scale_factor = unet, decoder, scale_factor
        self._levels = torch.as_tensor(ddpm_sigmas(1000)[::-1].copy())

    def denoise(self, x: torch.Tensor, sigma: torch.Tensor, cond: Dict) -> torch.Tensor:
        levels = self._levels.to(x.device)
        idx = torch.argmin((sigma[None, :] - levels[:, None]).abs(), dim=0)
        sigma = levels[idx]
        c_skip, c_out, c_in = (_bcast(s, x) for s in v_scaling(sigma))
        out = self.unet((x * c_in).permute(0, 3, 1, 2), idx, context=cond["crossattn"])
        return out.permute(0, 2, 3, 1) * c_out + x * c_skip

    @staticmethod
    def cfg_inputs(x, sigma: float, c: Dict, uc: Dict):
        return V3DPipeline.cfg_inputs(x, sigma, c, uc)

    @staticmethod
    def guide(denoised, scale: float) -> torch.Tensor:
        x_u, x_c = denoised.chunk(2)
        return x_u + scale * (x_c - x_u)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        x = self.decoder((z.float() / self.scale_factor).permute(0, 3, 1, 2))
        return ((x + 1.0) / 2.0).clamp(0.0, 1.0).permute(0, 2, 3, 1)


def euler(pipe, sigmas: np.ndarray, noise: torch.Tensor, c: Dict, uc: Dict,
          guidance, steps=None) -> torch.Tensor:
    """Euler over ``sigmas`` (ending in 0) from standard-normal ``noise``,
    each step's denoised output the guided CFG pair; ``steps`` stops early."""
    sig = torch.as_tensor(sigmas, device=noise.device)
    x = noise.float() * torch.sqrt(1.0 + sig[0] ** 2)
    for i in range(len(sigmas) - 1 if steps is None else steps):
        rows, s, cond = pipe.cfg_inputs(x, sigmas[i], c, uc)
        denoised = pipe.guide(pipe.denoise(rows, s, cond), guidance)
        x = x + (sig[i + 1] - sig[i]) * (x - denoised) / sig[i]
    return x


# -- the optimizer --------------------------------------------------------------

class AdamWEMA:
    """AdamW (betas 0.9 / 0.999, eps 1e-8, decoupled weight decay, bias
    corrected) on a list of float32 leaves, then the EMA with decay
    min(decay, (1 + n) / (10 + n)) at update n."""

    def __init__(self, params: List[torch.Tensor], weight_decay: float = 0.0,
                 ema_decay: float = 0.9999):
        self.params = params
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.ema = [p.detach().clone() for p in params]
        self.wd, self.ema_decay, self.n = weight_decay, ema_decay, 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], lr: float) -> None:
        self.n += 1
        b1, b2 = 0.9, 0.999
        bc1, bc2 = 1 - b1 ** self.n, 1 - b2 ** self.n
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1 - lr * self.wd)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(lr / bc1 * m / (v.sqrt() / math.sqrt(bc2) + 1e-8))
        d = min(self.ema_decay, (1.0 + self.n - 1) / (10.0 + self.n - 1))
        for e, p in zip(self.ema, self.params):
            e.lerp_(p, 1.0 - d)


def lambda_linear_lr(base: float, step: int, warm_up: int = 1, f_start: float = 1e-6) -> float:
    """V3D's LambdaLinear schedule: one warm-up step from f_start, then flat."""
    if step < warm_up:
        return base * (f_start + (1.0 - f_start) * step / max(warm_up, 1))
    return base
