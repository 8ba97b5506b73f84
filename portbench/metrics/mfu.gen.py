"""mfu.gen (%): the model FLOPs of the requests timed in the window (counted
by ``FlopCounterMode`` over the plain reference on the meta device: every
UNet forward, CLIP, the VAE encode and decode) over the window's wall time
and the bf16 peak of 989 TFLOP/s.  Moves gen_s."""

from portbench.bench.work import PEAK_BF16


def read(rec):
    if not rec.work or not rec.window_s:
        return None
    return 100.0 * rec.work["flops"] * rec.units / rec.window_s / PEAK_BF16
