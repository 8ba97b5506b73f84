"""k9_roofline.flux (%): K9 (``csrc/flash_attn_fwd_wide.cu``) at FLUX.1's
joint attention against its bound.  The work: each joint attention of a
transformer forward (``work["joint_attention"]``, (b, heads, sq, sk, d)
counted on the reference on meta: 57 at (1, 24, 4608, 4608, 128) at
1024^2), each its least time (``attention_work`` in bf16 at 989 TFLOP/s or
3.35 TB/s); the time: the traced request's device time of the kernels
named in ``KERNELS`` over its forwards.  Where the request launched K9
another number of times than the sites times the traffic's steps, the
routing has moved and the sites no longer bound what K9 ran: the metric
falls silent.  Moves gen_s."""

from portbench.bench.work import attention_work, bound_ms

KERNELS = ("flash_wide",)   # flash_wide_wgmma_kernel<128>


def read(rec):
    if rec.profile is None:
        return None
    sites = rec.work.get("joint_attention", ())
    steps = rec.traffic["params"].get("num_steps")
    t = rec.profile.kernel_s(KERNELS) / rec.profile.units
    if not t or not sites or not steps or \
            rec.launches.get("flash_attn_fwd_wide", 0) != len(sites) * steps:
        return None
    bound = sum(bound_ms(*attention_work(*a[:5], 2))[0] for a in sites) / 1e3
    return 100.0 * bound * steps / t


def lines(rec):
    sites = rec.work.get("joint_attention", ())
    shapes = sorted(set(map(tuple, sites)))
    return [f"K9 launches a unit: {rec.launches.get('flash_attn_fwd_wide', 0):g} (the site "
            f"walk expects {len(sites)} a forward x {rec.traffic['params'].get('num_steps')}: "
            f"{shapes})",
            f"K10 launches a unit: {rec.launches.get('layer_norm', 0):g}"]
