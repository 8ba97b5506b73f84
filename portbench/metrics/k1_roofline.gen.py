"""k1_roofline.gen (%): K1 (``csrc/flash_attn_fwd.cu``) against its bound.
The work: every spatial self-attention call of a request that the default
routing sends to K1 (``bench.work.k1_sites``), each its least time
(``attention_work`` in bf16 at 989 TFLOP/s or 3.35 TB/s), counted from the
reference's calls; the time: the traced request's device time of the
kernels named in ``KERNELS``.  Where the traced request launched K1 another
number of times than there are such sites, the routing has moved and the
sites no longer bound what K1 ran: the metric falls silent.  Moves gen_s."""

from portbench.bench.work import attention_work, bound_ms, k1_sites

KERNELS = ("flash_fwd",)   # flash_fwd_kernel, flash_fwd_wgmma_kernel


def sites(rec):
    return k1_sites(rec.work.get("attention", ()))


def read(rec):
    if rec.profile is None:
        return None
    t = rec.profile.kernel_s(KERNELS) / rec.profile.units
    work = sites(rec)
    if not t or not work or rec.launches.get("flash_attn_fwd", 0) != len(work):
        return None
    bound = sum(bound_ms(*attention_work(*a[:5], 2))[0] for a in work) / 1e3
    return 100.0 * bound / t


def lines(rec):
    calls = rec.work.get("attention", ())
    k1 = set(map(tuple, sites(rec)))
    kinds = {}
    for a in calls:
        key = (tuple(a[:5]), "self" if a[5] else "cross", "K1" if tuple(a) in k1 else "plain")
        kinds[key] = kinds.get(key, 0) + 1
    out = [f"attention sites a unit: {n} x (b, h, sq, sk, d) {k[0]} {k[1]} -> {k[2]}"
           for k, n in sorted(kinds.items())]
    out.append(f"K1 launches a unit: {rec.launches.get('flash_attn_fwd', 0):g} "
               f"(the site walk expects {len(sites(rec))})")
    return out
