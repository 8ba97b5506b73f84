"""Everything a run draws comes from ``--seed``.

``seed_for(seed, *keys)``: an independent 63-bit seed for each use (the
weights, request i's inputs, step i's batch), so that one seed gives the
same inputs whatever else the run does.  ``fill_seeded_`` fills a model's
parameters from one device generator in a few large draws: every leaf,
in the order of its name, takes the next stretch of one standard-normal
stream, scaled as the port's own seeded init scales it (weights
N(0, 1/fan_in), norm scales 1 + N(0, 0.1), every other vector N(0, 0.1)).
The port's engine and the reference are filled by the same call on the
same seed, so they hold the same numbers.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

CHUNK = 1 << 26   # values a draw (256 MiB of float32)


def seed_for(seed: int, *keys) -> int:
    words = [int(seed) & (2**64 - 1)]
    for k in keys:
        words.append(k & (2**64 - 1) if isinstance(k, int) else
                     int.from_bytes(str(k).encode()[:8].ljust(8, b"\0"), "little"))
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def generator(device, seed: int, *keys) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_for(seed, *keys))


def init_scale(module: nn.Module, name: str, param: torch.Tensor) -> Tuple[float, float]:
    """(mean, std) of a leaf."""
    if param.dim() >= 2:
        return 0.0, 1.0 / math.sqrt(math.prod(param.shape[1:]))
    if isinstance(module, (nn.GroupNorm, nn.LayerNorm)) and name == "weight":
        return 1.0, 0.1
    return 0.0, 0.1


def leaves(model: nn.Module) -> List[Tuple[str, nn.Module, str, torch.Tensor]]:
    """(full name, owning module, local name, parameter), sorted by name."""
    out = []
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            out.append((f"{mname}.{pname}" if mname else pname, mod, pname, p))
    return sorted(out, key=lambda x: x[0])


def stream(device, seed: int) -> Iterator[torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    while True:
        yield torch.randn(CHUNK, generator=gen, device=device)


def seeded_values(model: nn.Module, seed: int, device,
                  values_dtype: Optional[torch.dtype] = None
                  ) -> Iterator[Tuple[str, torch.Tensor, torch.Tensor]]:
    """(name, parameter, its seeded values as float32) leaf by leaf, each
    rounded through ``values_dtype`` when given (the dtype the weights are
    served in)."""
    src = stream(device, seed)
    buf, pos = next(src), 0
    for name, mod, pname, p in leaves(model):
        mean, std = init_scale(mod, pname, p)
        n = p.numel()
        parts = []
        while n:
            if pos == buf.numel():
                buf, pos = next(src), 0
            k = min(n, buf.numel() - pos)
            parts.append(buf[pos:pos + k])
            pos += k
            n -= k
        vals = (parts[0] if len(parts) == 1 else torch.cat(parts)) * std + mean
        if values_dtype is not None:
            vals = vals.to(values_dtype).float()
        yield name, p, vals.view(p.shape)


@torch.no_grad()
def fill_seeded_(model: nn.Module, seed: int, values_dtype: Optional[torch.dtype] = None
                 ) -> nn.Module:
    """Fill every parameter of ``model`` (on its device) from ``seed``."""
    device = next(model.parameters()).device
    for _, p, vals in seeded_values(model, seed, device, values_dtype):
        p.copy_(vals)
    return model
