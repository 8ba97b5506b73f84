"""mfu.train (%): 3 x the forward FLOPs of a step's rows (counted by
``FlopCounterMode`` over the plain reference's forward on the meta device;
the recomputation of checkpointed blocks not counted) times the window's
steps, over the window's wall time and the bf16 peak of 989 TFLOP/s.
Moves train_step_ms."""

from portbench.bench.work import PEAK_BF16


def read(rec):
    if not rec.work or not rec.window_s:
        return None
    return 100.0 * 3 * rec.work["flops"] * rec.units / rec.window_s / PEAK_BF16
