"""optim_ms.train (ms): device time a step of the optimizer's multi-tensor
kernels in the traced steps: AdamW's foreach updates, the EMA's foreach
lerp and the gradient norm's foreach reductions (``KERNELS``, by name).
Moves train_step_ms."""

KERNELS = ("adam", "multi_tensor", "foreach", "lerp")


def read(rec):
    if rec.profile is None:
        return None
    t = rec.profile.kernel_s(KERNELS)
    return 1e3 * t / rec.profile.units if t else None
