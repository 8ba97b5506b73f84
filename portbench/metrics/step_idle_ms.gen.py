"""step_idle_ms.gen (ms): the device's idle time a sampler step, in the
gaps whose midpoint lies in a ``sampler.step`` span (the host behind the
device inside a step), in the traced request (``bench/spans.py``).
Silent unless the request holds the traffic's steps, each with one
forward.  Moves gen_s."""

from portbench.bench import spans


def read(rec):
    s = spans.sampling(rec)
    return None if s is None else s["idle_ms"]


def lines(rec):
    return spans.lines(rec)
