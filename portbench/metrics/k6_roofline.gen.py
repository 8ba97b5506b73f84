"""k6_roofline.gen (%): K6 (``csrc/group_norm.cu``) against its bound.  The
work: every GroupNorm call of a request (the UNet's, the VAE encoder's and
decoder's), each its least time (``group_norm_work`` on bf16 activations and
parameters), counted from the reference's calls; the time: the traced
request's device time of the kernels named in ``KERNELS``.  Where the
traced request launched K6 another number of times than there are such
calls, the routing has moved and the calls no longer bound what K6 ran:
the metric falls silent.  Moves gen_s."""

from portbench.bench.work import bound_ms, group_norm_work

KERNELS = ("gn_slice", "gn_stats", "gn_norm")


def read(rec):
    if rec.profile is None:
        return None
    t = rec.profile.kernel_s(KERNELS) / rec.profile.units
    calls = rec.work.get("group_norm", ())
    if not t or not calls or rec.launches.get("group_norm", 0) != len(calls):
        return None
    bound = sum(bound_ms(*group_norm_work(shape, silu, 2, 2))[0] for shape, silu in calls)
    return 100.0 * bound / 1e3 / t


def lines(rec):
    return [f"K6 launches a unit: {rec.launches.get('group_norm', 0):g} "
            f"(the site walk expects {len(rec.work.get('group_norm', ()))})"]
