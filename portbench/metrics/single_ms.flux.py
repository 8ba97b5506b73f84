"""single_ms.flux (ms): the device time a transformer forward of the work
launched under FLUX.1's ``flux.single`` spans (the 38 single-stream blocks:
the modulation and LayerNorm, linear1, the attention beside the tanh-GELU
MLP, linear2 and the gate), in the traced request (``bench/blocks.py``).
Moves gen_s."""

from portbench.bench import blocks


def read(rec):
    return blocks.forward_ms(rec, "flux.single")
