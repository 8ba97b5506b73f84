"""double_ms.flux (ms): the device time a transformer forward of the work
launched under FLUX.1's ``flux.double`` spans (the 19 double-stream blocks:
modulations, LayerNorms, the per-stream projections, the joint attention,
the MLPs), in the traced request (``bench/blocks.py``).  Moves gen_s."""

from portbench.bench import blocks, spans


def read(rec):
    return blocks.forward_ms(rec, "flux.double")


def lines(rec):
    return spans.lines(rec)
