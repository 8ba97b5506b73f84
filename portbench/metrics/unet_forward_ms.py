"""unet_forward_ms (ms): the sampling stage's whole time over its UNet
forwards (the sampler's Euler steps, each one CFG-doubled forward and its
guidance), the mean over the window's requests.  Moves gen_s."""


def read(rec):
    vals = [1e3 * s["sample_s"] / s["forwards"] for s in rec.stages
            if s.get("forwards") and "sample_s" in s]
    return sum(vals) / len(vals) if vals else None
