"""bwd_attn_roofline.train (%): the attention backward pair K8 + K7
(``csrc/flash_attn_bwd.cu``) against its bound.  The work: every
self-attention call of a step's forward that runs K1
(``bench.work.k1_sites``), each the pair's least time (``flash_bwd_work``: K8's
3 and K7's 4 products of 2 b h s^2 64 FLOP, bf16 at 989 TFLOP/s); the
time: the traced steps' device time of the kernels named in ``KERNELS``,
a step.  Where a traced step launched K8 or K7 another number of times
than there are such sites, the routing has moved and the sites no longer
bound what ran: the metric falls silent.  Moves train_step_ms."""

from portbench.bench.work import BWD_PRODUCTS, bound_ms, flash_bwd_work, k1_sites

KERNELS = ("flash_bwd_dq", "flash_bwd_dkv")
LAUNCH_KEYS = ("flash_attn_bwd_dq", "flash_attn_bwd_dkv")


def read(rec):
    if rec.profile is None:
        return None
    t = rec.profile.kernel_s(KERNELS) / rec.profile.units
    work = k1_sites(rec.work.get("attention", ()))
    if not t or not work or any(rec.launches.get(k, 0) != len(work) for k in LAUNCH_KEYS):
        return None
    bound = sum(bound_ms(*flash_bwd_work(a[0], a[1], a[2], n))[0]
                for a in work for n in BWD_PRODUCTS.values())
    return 100.0 * bound / 1e3 / t


def lines(rec):
    return [f"K8 / K7 launches a step: {rec.launches.get('flash_attn_bwd_dq', 0):g} / "
            f"{rec.launches.get('flash_attn_bwd_dkv', 0):g}"]
