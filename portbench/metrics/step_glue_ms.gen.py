"""step_glue_ms.gen (ms): the device time a sampler step of the work
launched under ``sampler.step`` but outside its ``unet.forward`` (the CFG
doubling, the preconditioning, the guidance, the Euler update), in the
traced request (``bench/spans.py``).  Silent unless the request holds the
traffic's steps, each with one forward.  Moves gen_s."""

from portbench.bench import spans


def read(rec):
    s = spans.sampling(rec)
    return None if s is None else s["glue_ms"]


def lines(rec):
    return spans.lines(rec)
