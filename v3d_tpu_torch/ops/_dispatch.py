"""Kernel dispatch: plain version on the CPU, hand-written kernel on CUDA.

A wrapper takes its plain PyTorch version only because the tensors it was
given lie on the CPU, or inside an explicit ``reference_mode()`` (comparison
runs and tests only; nothing on the main path enters it).  Inside
``meta_shapes()`` meta tensors take it too: shapes only, no value computed
(the dry run's full-size stage); elsewhere a meta tensor raises.  For a CUDA tensor
it launches its kernel or raises: there is no fallback.  Each wrapper counts
its launches in ``LAUNCHES``, where it launches and nowhere else.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

LAUNCHES: Dict[str, int] = {"flash_attn_fwd": 0, "temporal_block": 0,
                            "temporal_core": 0, "gs_composite_fwd": 0,
                            "gs_composite_bwd": 0, "group_norm": 0,
                            "group_norm_stats": 0, "group_norm_apply": 0,
                            "flash_attn_bwd_dkv": 0, "flash_attn_bwd_dq": 0,
                            "flash_attn_fwd_wide": 0}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Process-wide, not a ContextVar: the autograd engine runs a CUDA backward,
# and the forward recomputed by activation checkpointing, on threads of its
# own, which do not see the context of the thread that entered the block.
_REFERENCE = False
_META = False


@contextlib.contextmanager
def meta_shapes():
    """Route meta tensors to the plain versions inside the block (a forward
    on the meta device: its shapes, no values, no launch)."""
    global _META
    saved, _META = _META, True
    try:
        yield
    finally:
        _META = saved


@contextlib.contextmanager
def reference_mode():
    """Route CUDA tensors to the plain versions inside the block, in every
    thread (the backward included) until the block exits."""
    global _REFERENCE
    saved, _REFERENCE = _REFERENCE, True
    try:
        yield
    finally:
        _REFERENCE = saved


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def use_plain(*tensors: torch.Tensor) -> bool:
    """True where the plain version runs: CPU tensors, reference mode, and
    meta tensors inside ``meta_shapes()``."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu" or (dev.type == "meta" and _META):
        return True
    if dev.type == "cuda":
        return _REFERENCE
    raise ValueError(f"no kernel or plain version for device {dev}")


def needs_grad(*tensors: torch.Tensor) -> bool:
    """True where autograd will want a gradient of one of ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def plain_vjp(plain_fn, saved, needs_input_grad, grad, *args):
    """Backward by recomputation: the vector-Jacobian product of
    ``plain_fn(*saved, *args)`` with ``grad``, for the saved inputs autograd
    asks for (None for the others and for ``args``), as the JAX package's
    custom VJPs do with ``jax.vjp`` of their XLA formulas."""
    inputs = [t.detach().requires_grad_(need)
              for t, need in zip(saved, needs_input_grad)]
    wanted = [t for t in inputs if t.requires_grad]
    with torch.enable_grad():
        out = plain_fn(*inputs, *args)
        got = iter(torch.autograd.grad(out, wanted, grad))
    return tuple(next(got) if t.requires_grad else None
                 for t in inputs) + (None,) * len(args)


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
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError_t {err}")
    LAUNCHES[name] += 1
