"""Kernel dispatch: plain version on the CPU, hand-written kernel on CUDA.

A wrapper takes its plain PyTorch version only because the tensors it was
given lie on the CPU, or inside an explicit ``reference_mode()`` (comparison
runs and tests only; nothing on the main path enters it).  For a CUDA tensor
it launches its kernel or raises: there is no fallback.  Each wrapper counts
its launches in ``LAUNCHES``, where it launches and nowhere else.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict

import torch

LAUNCHES: Dict[str, int] = {"flash_attn_fwd": 0, "temporal_block": 0,
                            "temporal_core": 0, "gs_composite_fwd": 0,
                            "gs_composite_bwd": 0}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_REFERENCE = contextvars.ContextVar("v3d_tpu_torch_reference_mode",
                                    default=False)


@contextlib.contextmanager
def reference_mode():
    """Route CUDA tensors to the plain versions inside the block."""
    token = _REFERENCE.set(True)
    try:
        yield
    finally:
        _REFERENCE.reset(token)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def use_plain(*tensors: torch.Tensor) -> bool:
    """True where the plain version runs: CPU tensors, or reference mode."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return _REFERENCE.get()
    raise ValueError(f"no kernel or plain version for device {dev}")


def check_kernel_inputs(name: str, *tensors: torch.Tensor) -> int:
    """Dtype check shared by the wrappers; returns the kernel's dtype code."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or next(iter(dtypes)) not in DTYPE_CODES:
        raise TypeError(f"{name}: needs one dtype of float32/bfloat16, "
                        f"got {sorted(map(str, dtypes))}")
    for t in tensors:
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: last dim must be unit-stride, "
                             f"got strides {t.stride()}")
    return DTYPE_CODES[tensors[0].dtype]


def launch(name: str, fn_name: str, device: torch.device, *args) -> None:
    """Call one exported C function on ``device``'s current stream; raise on
    a non-zero cudaError_t and count the launch."""
    from v3d_tpu_torch.kernels.build import library

    fn = getattr(library(), fn_name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError_t {err}")
    LAUNCHES[name] += 1
