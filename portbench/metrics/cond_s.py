"""cond_s (s): a request's conditioning (CLIP embedding, VAE encode and its
noise, the cond vector), ``sample_one``'s own timing of the synchronised
stage, the mean over the window's requests.  Moves gen_s."""


def read(rec):
    vals = [s["cond_s"] for s in rec.stages if "cond_s" in s]
    return sum(vals) / len(vals) if vals else None
