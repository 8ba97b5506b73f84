"""unet_device_ms.gen (ms): the device time of the work launched under the
port's ``unet.forward`` spans (``engines/wrappers.py``'s network, the image
engine's) inside the traced request's sampler steps, over those forwards:
one CFG-doubled UNet forward's device time (``bench/spans.py``).  Silent
unless the request holds the traffic's steps, each with one forward.
Moves gen_s."""

from portbench.bench import spans


def read(rec):
    s = spans.sampling(rec)
    return None if s is None else s["unet_ms"]


def lines(rec):
    return spans.lines(rec)
