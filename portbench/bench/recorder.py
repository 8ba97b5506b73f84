"""What the correctness check reads of a request while it runs: a wrapper of
the engine's denoiser that keeps, at a few calls drawn from the seed, the
input rows' first half (the CFG pair repeats x), sigma and the output, and
the conditioning of the request's first call.  Copies stay on the device
until the request has finished.  ``euler_guided`` reads the sampler's own
arithmetic (guidance and the Euler step) back from the kept states."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.bench.seeded import seed_for


def checked_calls(seed: int, steps: int, count: int):
    """The first and the last sampler step, and ``count - 2`` consecutive
    steps between them from one drawn from the seed: a kept step followed
    by a kept step, or the last step followed by the sampler's result,
    shows one whole Euler step."""
    draw = np.random.default_rng(seed_for(seed, "checked steps"))
    start = int(draw.integers(1, steps - count + 2))
    return [0, steps - 1, *range(start, start + count - 2)]


def euler_guided(steps, final: torch.Tensor, sigmas) -> Dict[int, torch.Tensor]:
    """For each kept step k whose next state is known (the next kept step's
    input, or the sampler's result after the last step), the guided
    denoised value g_k that the program's step implies.  Euler moves x_k to
    x_k + (s_{k+1} - s_k) (x_k - g_k) / s_k, so g_k = x_k + (x_{k+1} - x_k)
    s_k / (s_k - s_{k+1}); ``sigmas`` ends in 0.  In float64."""
    last = len(sigmas) - 2
    out = {}
    for k, (x, _, _) in steps.items():
        nxt = steps[k + 1][0] if k + 1 in steps else final if k == last else None
        if nxt is None:
            continue
        s, s1 = float(sigmas[k]), float(sigmas[k + 1])
        x = x.double()
        out[k] = x + (nxt.double() - x) * (s / (s - s1))
    return out


class DenoiserRecorder:
    def __init__(self, inner, calls):
        self.inner, self.calls_kept = inner, set(calls)
        self.reset()

    def reset(self):
        self.calls, self.cond, self.kept = 0, None, {}

    def __call__(self, network, x, sigma, cond, **kw):
        out = self.inner(network, x, sigma, cond, **kw)
        if self.calls == 0:
            self.cond = {k: v.detach().clone() for k, v in cond.items()}
        if self.calls in self.calls_kept:
            n = x.shape[0] // 2
            self.kept[self.calls] = (x[:n].detach().clone(), sigma.flatten()[0].clone(),
                                     out.detach().clone())
        self.calls += 1
        return out

    def taken(self):
        """The request's records on the host (once it has finished)."""
        return ({k: v.cpu() for k, v in self.cond.items()},
                {k: (x.cpu(), float(s), o.cpu()) for k, (x, s, o) in self.kept.items()})
