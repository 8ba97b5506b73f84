"""joint_attn_ms.flux (ms): the device time a transformer forward of the
work launched under FLUX.1's ``flux.attention`` spans (each block's QK
RMSNorm, the streams' concatenation, RoPE on q and k, K9 and its layout
copies), in the traced request (``bench/blocks.py``).  Moves gen_s."""

from portbench.bench import blocks


def read(rec):
    return blocks.forward_ms(rec, "flux.attention")


def lines(rec):
    return [f"flux spans in the traced forwards: double {blocks.count(rec, 'flux.double')}, "
            f"single {blocks.count(rec, 'flux.single')}, attention "
            f"{blocks.count(rec, 'flux.attention')}"]
