"""Diffusion samplers (counterpart of v3d_tpu/diffusion/sampling.py; sgm
sampling.py): EDM Euler (V3D's) and Heun, Euler ancestral, DPM-Solver++(2S)
ancestral, DPM-Solver++(2M) and linear multistep.

The JAX package runs each loop as one ``lax.scan`` and picks between
branches on the device (``lax.cond`` / ``where``); here the loop is Python
over the precomputed sigma schedule and every branch is decided on the host
from the float32 numpy schedule, so no step waits for the card and each
sampler calls the network a fixed number of times: Heun and DPM++(2S)
ancestral 2n - 1 times (no second call on the last step), the others n.

A sampler is called as ``sampler(denoiser, x, cond, uc, generator=...,
num_steps=..., noises=...)`` with ``denoiser(x, sigma, cond)``.  Noise is
drawn only by the ancestral samplers and by Euler's churn: draw ``i`` is
``noises[i]`` when a list of n tensors is given (the JAX package draws one
per step, the last unused), else it comes from ``generator``.  Each
sampler's ``sample`` runs inside a ``sampler.run`` span and each step's
body inside a ``sampler.step`` span (``utils/trace.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from v3d_tpu_torch.core.registry import register
from v3d_tpu_torch.diffusion.denoise import append_dims
from v3d_tpu_torch.diffusion.guidance import IdentityGuider
from v3d_tpu_torch.utils.trace import span

Cond = Dict[str, torch.Tensor]


def to_d(x: torch.Tensor, sigma: torch.Tensor, denoised: torch.Tensor) -> torch.Tensor:
    """Karras ODE derivative dx/dsigma (sampling_utils.py:35-36)."""
    return (x - denoised) / append_dims(sigma, x.dim())


def get_ancestral_step(sigma_from, sigma_to, eta: float = 1.0):
    """(sigma_down, sigma_up) of an ancestral step; torch tensors or numpy
    float32 scalars alike."""
    lib = torch if isinstance(sigma_to, torch.Tensor) else np
    if not eta:
        return sigma_to, lib.zeros_like(sigma_to)
    sigma_up = lib.minimum(
        sigma_to,
        eta * lib.sqrt(sigma_to**2 * (sigma_from**2 - sigma_to**2) / sigma_from**2))
    sigma_down = lib.sqrt(sigma_to**2 - sigma_up**2)
    return sigma_down, sigma_up


@dataclasses.dataclass(frozen=True)
class BaseDiffusionSampler:
    discretization: object = None
    num_steps: Optional[int] = None
    guider: object = dataclasses.field(default_factory=IdentityGuider)

    def __call__(self, denoiser: Callable, x: torch.Tensor, cond: Cond,
                 uc: Optional[Cond] = None,
                 generator: Optional[torch.Generator] = None,
                 num_steps: Optional[int] = None,
                 noises: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """The sampler's run (``sample``) inside a ``sampler.run`` span."""
        with span("sampler.run"):
            return self.sample(denoiser, x, cond, uc, generator=generator,
                               num_steps=num_steps, noises=noises)

    @staticmethod
    def steps(n: int):
        """Step indices 0 .. n - 1, the loop body of each inside a
        ``sampler.step`` span (attribute ``step``)."""
        for i in range(n):
            with span("sampler.step", step=i):
                yield i

    def schedule(self, num_steps: Optional[int] = None) -> np.ndarray:
        n = num_steps if num_steps is not None else self.num_steps
        if n is None:
            raise ValueError("num_steps not set")
        return np.asarray(self.discretization(n))  # n + 1 values, ends in 0

    def prepare(self, x: torch.Tensor, num_steps: Optional[int] = None):
        """The schedule (numpy, and as tensors in the sigma dtype
        ``result_type(x.dtype, float32)``) and the initial latent scaled to
        its top as the discretization says (``Discretization.start``:
        sampling.py:50's sqrt(1 + sigma0^2), 1 for a flow)."""
        sigmas_np = self.schedule(num_steps)
        sdt = torch.promote_types(x.dtype, torch.float32)
        sigmas = torch.as_tensor(sigmas_np, dtype=sdt, device=x.device)
        return self.discretization.start(x, sigmas[0]), sigmas_np, sigmas

    def denoise(self, x, denoiser, sigma: torch.Tensor, cond: Cond, uc: Cond):
        s = sigma.to(x.dtype).expand(x.shape[0])
        x_in, s_in, c_in = self.guider.prepare_inputs(x, s, cond, uc)
        return self.guider(denoiser(x_in, s_in, c_in), sigma)

    @staticmethod
    def draw(i: int, x: torch.Tensor, noises: Optional[Sequence[torch.Tensor]],
             generator: Optional[torch.Generator]) -> torch.Tensor:
        if noises is not None:
            return noises[i].to(device=x.device, dtype=x.dtype)
        return torch.randn(x.shape, dtype=x.dtype, device=x.device,
                           generator=generator)


@register("euler_edm_sampler")
@dataclasses.dataclass(frozen=True)
class EulerEDMSampler(BaseDiffusionSampler):
    """EDM stochastic Euler sampler (sgm sampling.py:85-133, 214-219).  With
    ``s_churn = 0`` (V3D) no noise is drawn."""

    s_churn: float = 0.0
    s_tmin: float = 0.0
    s_tmax: float = float("inf")
    s_noise: float = 1.0

    def gammas(self, sigmas: np.ndarray) -> np.ndarray:
        n = len(sigmas)
        g = np.zeros(n - 1, dtype=np.float32)
        for i in range(n - 1):
            if self.s_tmin <= sigmas[i] <= self.s_tmax:
                g[i] = min(self.s_churn / (n - 1), 2**0.5 - 1)
        return g

    def correct(self, euler, x, d, dt, next_sigma, next_sigma_np, denoiser,
                cond, uc):
        return euler

    def sample(self, denoiser: Callable, x: torch.Tensor, cond: Cond,
               uc: Optional[Cond] = None,
               generator: Optional[torch.Generator] = None,
               num_steps: Optional[int] = None,
               noises: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        uc = cond if uc is None else uc
        x, sigmas_np, sigmas = self.prepare(x, num_steps)
        gammas = self.gammas(sigmas_np)
        for i in self.steps(len(sigmas_np) - 1):
            sigma, next_sigma = sigmas[i], sigmas[i + 1]
            sigma_hat = sigma * (float(gammas[i]) + 1.0)
            if gammas[i] > 0:
                noise = self.draw(i, x, noises, generator) * self.s_noise
                x = x + noise * torch.sqrt(sigma_hat**2 - sigma**2).to(x.dtype)
            denoised = self.denoise(x, denoiser, sigma_hat, cond, uc)
            d = (x - denoised) / append_dims(sigma_hat.to(x.dtype), x.dim())
            dt = (next_sigma - sigma_hat).to(x.dtype)
            x = self.correct(x + dt * d, x, d, dt, next_sigma, sigmas_np[i + 1],
                             denoiser, cond, uc)
        return x


@register("heun_edm_sampler")
@dataclasses.dataclass(frozen=True)
class HeunEDMSampler(EulerEDMSampler):
    """2nd-order Heun correction (sampling.py:221-238), skipped on the last
    step (next sigma 0)."""

    def correct(self, euler, x, d, dt, next_sigma, next_sigma_np, denoiser,
                cond, uc):
        if not next_sigma_np > 1e-14:
            return euler
        denoised = self.denoise(euler, denoiser, next_sigma, cond, uc)
        d_new = to_d(euler, next_sigma, denoised)
        return x + dt * (d + d_new) / 2.0


@register("euler_ancestral_sampler")
@dataclasses.dataclass(frozen=True)
class EulerAncestralSampler(BaseDiffusionSampler):
    """Ancestral Euler with eta-controlled noise (sampling.py:240-248)."""

    eta: float = 1.0
    s_noise: float = 1.0

    def sample(self, denoiser, x, cond: Cond, uc: Optional[Cond] = None,
               generator: Optional[torch.Generator] = None,
               num_steps: Optional[int] = None,
               noises: Optional[Sequence[torch.Tensor]] = None):
        uc = cond if uc is None else uc
        x, sigmas_np, sigmas = self.prepare(x, num_steps)
        for i in self.steps(len(sigmas_np) - 1):
            sigma, next_sigma = sigmas[i], sigmas[i + 1]
            sigma_down, sigma_up = get_ancestral_step(sigma, next_sigma, self.eta)
            denoised = self.denoise(x, denoiser, sigma, cond, uc)
            d = to_d(x, sigma, denoised)
            x = x + (sigma_down - sigma).to(x.dtype) * d
            if sigmas_np[i + 1] > 0.0:
                noise = self.draw(i, x, noises, generator)
                x = x + noise * self.s_noise * sigma_up.to(x.dtype)
        return x


@register("dpmpp2s_ancestral_sampler")
@dataclasses.dataclass(frozen=True)
class DPMPP2SAncestralSampler(BaseDiffusionSampler):
    """DPM-Solver++(2S) ancestral (sampling.py:250-288); the second-order
    update (and its network call) only while sigma_down > 1e-14, i.e. not
    on the last step."""

    eta: float = 1.0
    s_noise: float = 1.0

    def sample(self, denoiser, x, cond: Cond, uc: Optional[Cond] = None,
               generator: Optional[torch.Generator] = None,
               num_steps: Optional[int] = None,
               noises: Optional[Sequence[torch.Tensor]] = None):
        uc = cond if uc is None else uc
        x, sigmas_np, sigmas = self.prepare(x, num_steps)
        for i in self.steps(len(sigmas_np) - 1):
            sigma, next_sigma = sigmas[i], sigmas[i + 1]
            sigma_down, sigma_up = get_ancestral_step(sigma, next_sigma, self.eta)
            down_np, _ = get_ancestral_step(sigmas_np[i], sigmas_np[i + 1], self.eta)
            denoised = self.denoise(x, denoiser, sigma, cond, uc)
            if down_np > 1e-14:
                t, t_next = -torch.log(sigma), -torch.log(sigma_down)
                h = t_next - t
                s = t + 0.5 * h
                mult1 = torch.exp(-s) / torch.exp(-t)
                mult2 = torch.expm1(-0.5 * h)
                mult3 = torch.exp(-t_next) / torch.exp(-t)
                mult4 = torch.expm1(-h)
                x2 = mult1.to(x.dtype) * x - mult2.to(x.dtype) * denoised
                denoised2 = self.denoise(x2, denoiser, torch.exp(-s), cond, uc)
                x = mult3.to(x.dtype) * x - mult4.to(x.dtype) * denoised2
            else:
                d = to_d(x, sigma, denoised)
                x = x + (sigma_down - sigma).to(x.dtype) * d
            if sigmas_np[i + 1] > 0.0:
                noise = self.draw(i, x, noises, generator)
                x = x + noise * self.s_noise * sigma_up.to(x.dtype)
        return x


@register("dpmpp2m_sampler")
@dataclasses.dataclass(frozen=True)
class DPMPP2MSampler(BaseDiffusionSampler):
    """DPM-Solver++(2M) multistep (sampling.py:290-365): the first step and
    the last (next sigma 0, where t_next and h are +inf and the update
    reduces to the denoised estimate) take the first-order update, the
    others the correction by the previous denoised estimate."""

    def sample(self, denoiser, x, cond: Cond, uc: Optional[Cond] = None,
               generator: Optional[torch.Generator] = None,
               num_steps: Optional[int] = None,
               noises: Optional[Sequence[torch.Tensor]] = None):
        uc = cond if uc is None else uc
        x, sigmas_np, sigmas = self.prepare(x, num_steps)
        old_denoised = None
        for i in self.steps(len(sigmas_np) - 1):
            sigma, next_sigma = sigmas[i], sigmas[i + 1]
            denoised = self.denoise(x, denoiser, sigma, cond, uc)
            t, t_next = -torch.log(sigma), -torch.log(next_sigma)
            h = t_next - t
            mult1 = (torch.exp(-t_next) / torch.exp(-t)).to(x.dtype)
            mult2 = torch.expm1(-h).to(x.dtype)
            if i == 0 or sigmas_np[i + 1] < 1e-14:
                x = mult1 * x - mult2 * denoised
            else:
                h_last = t - (-torch.log(sigmas[i - 1]))
                r = h_last / torch.where(h == 0, 1.0, h)
                safe_r = torch.where(r == 0, 1.0, r)
                mult3 = (1 + 1 / (2 * safe_r)).to(x.dtype)
                mult4 = (1 / (2 * safe_r)).to(x.dtype)
                denoised_d = mult3 * denoised - mult4 * old_denoised
                x = mult1 * x - mult2 * denoised_d
            old_denoised = denoised
        return x


@register("linear_multistep_sampler")
@dataclasses.dataclass(frozen=True)
class LinearMultistepSampler(BaseDiffusionSampler):
    """Adams-Bashforth style multistep (sampling.py:176-212): coefficients
    integrated over the float64 schedule with scipy and stored as float32;
    the last ``order`` derivatives kept newest first."""

    order: int = 4

    def coeff_table(self, sigmas: np.ndarray) -> np.ndarray:
        from scipy import integrate

        n = len(sigmas) - 1
        table = np.zeros((n, self.order), dtype=np.float32)
        t = sigmas.astype(np.float64)
        for i in range(n):
            cur_order = min(i + 1, self.order)
            for j in range(cur_order):
                def fn(tau, i=i, j=j, cur_order=cur_order):
                    prod = 1.0
                    for k in range(cur_order):
                        if j == k:
                            continue
                        prod *= (tau - t[i - k]) / (t[i - j] - t[i - k])
                    return prod

                table[i, j] = integrate.quad(fn, t[i], t[i + 1], epsrel=1e-4)[0]
        return table

    def sample(self, denoiser, x, cond: Cond, uc: Optional[Cond] = None,
               generator: Optional[torch.Generator] = None,
               num_steps: Optional[int] = None,
               noises: Optional[Sequence[torch.Tensor]] = None):
        uc = cond if uc is None else uc
        x, sigmas_np, sigmas = self.prepare(x, num_steps)
        coeffs = torch.as_tensor(self.coeff_table(sigmas_np), dtype=sigmas.dtype,
                                 device=x.device)
        ds = torch.zeros((self.order,) + tuple(x.shape), dtype=x.dtype,
                         device=x.device)
        for i in self.steps(len(sigmas_np) - 1):
            denoised = self.denoise(x, denoiser, sigmas[i], cond, uc)
            d = to_d(x, sigmas[i], denoised)
            ds = torch.cat([d[None], ds[:-1]], dim=0)
            x = x + torch.tensordot(coeffs[i].to(x.dtype), ds, dims=1)
        return x
