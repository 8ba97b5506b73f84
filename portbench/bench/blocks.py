"""Device time a network forward of the work launched under one kind of
the port's block spans (``models/flux.py``'s ``flux.double``,
``flux.single``, ``flux.attention``), in the traced request's sampler steps
(``bench/spans.py``).  None unless the request holds the traffic's steps,
each with one forward (``spans.sampling``), and the spans come a whole
number of times a forward (a checkout without them, or a buffer that
dropped some, falls silent)."""

from __future__ import annotations

from typing import Optional

from portbench.bench import spans


def forward_ms(rec, name: str) -> Optional[float]:
    if spans.sampling(rec) is None:
        return None
    att = spans.for_record(rec)
    forwards = att.named("unet.forward", under="sampler.step")
    got = att.named(name, under="unet.forward")
    if not got or len(got) % len(forwards):
        return None
    return 1e3 * att.device(got) / len(forwards)


def count(rec, name: str) -> int:
    """The spans called ``name`` inside the traced slice's forwards."""
    att = spans.for_record(rec)
    return 0 if att is None else len(att.named(name, under="unet.forward"))
