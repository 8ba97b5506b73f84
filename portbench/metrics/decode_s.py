"""decode_s (s): a request's VAE decode to uint8 frames or images on the
host, timed around the synchronised stage (``sample_one``'s timing, or the
image entry's), the mean over the window's requests.  Moves gen_s."""


def read(rec):
    vals = [s["decode_s"] for s in rec.stages if "decode_s" in s]
    return sum(vals) / len(vals) if vals else None
