"""The port's GeneralConditioner with UCG dropout against the JAX package's:
V3D's five embedders (two identity image conds with ucg_rate 0.2, three
sinusoidal scalar embedders) on the same batch, with the keep masks the
JAX keys draw handed to the port: the dropped image conds (crossattn,
concat) equal; the vector within test_torch_diffusion.py's EMB_TOL (float32
sinusoids of arguments up to 300 rad, where one ulp of the argument is
3e-5).  get_unconditional_conditioning keeps UCG off."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from v3d_tpu.engines.builder import build_tiny_engine as jax_tiny_engine
from v3d_tpu_torch.engines.builder import build_tiny_engine

B = 6
EMB_TOL = dict(rtol=1e-4, atol=1e-4)


def _same(got, want):
    for k in want:
        if k == "vector":
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **EMB_TOL)
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def _batch(lib):
    rs = np.random.RandomState(0)
    arr = jnp.asarray if lib == "jax" else (lambda a: torch.from_numpy(np.array(a)))
    return {
        "cond_frames_without_noise": arr(rs.randn(B, 1, 16).astype(np.float32)),
        "cond_frames": arr(rs.randn(B, 4, 4, 4).astype(np.float32)),
        "fps_id": arr(np.full(B, 6.0, np.float32)),
        "motion_bucket_id": arr(rs.uniform(0, 300, B).astype(np.float32)),
        "cond_aug": arr(np.full(B, 0.02, np.float32)),
    }


def test_ucg_dropout_matches_jax_with_injected_masks():
    jcond = jax_tiny_engine(num_frames=2, resolution=64).conditioner()
    pcond = build_tiny_engine(num_frames=2, device="cpu").conditioner()
    assert [(s.input_key, s.ucg_rate, s.is_trainable, s.needs_rng) for s in jcond.embedders] \
        == [(s.input_key, s.ucg_rate, s.is_trainable, s.needs_rng) for s in pcond.embedders]
    rng = jax.random.PRNGKey(7)  # drops rows of both image conds
    want = jcond(_batch("jax"), rng=rng, apply_ucg=True)
    # the JAX conditioner splits rng once per embedder with ucg_rate > 0, in order
    keep, r = {}, rng
    for spec in jcond.embedders:
        if spec.ucg_rate > 0:
            r, sub = jax.random.split(r)
            keep[spec.input_key] = torch.from_numpy(np.array(
                jax.random.bernoulli(sub, 1.0 - spec.ucg_rate, (B,))))
    assert all(not bool(k.all()) for k in keep.values())
    got = pcond(_batch("torch"), apply_ucg=True, keep=keep)
    assert set(got) == set(want) == {"crossattn", "concat", "vector"}
    _same(got, want)

    # drawn masks keep whole rows, each either the embedding or zero
    drawn = pcond(_batch("torch"), apply_ucg=True,
                  generator=torch.Generator().manual_seed(0))
    plain = pcond(_batch("torch"))
    for k in ("crossattn", "concat"):
        for i in range(B):
            assert (torch.equal(drawn[k][i], plain[k][i])
                    or not drawn[k][i].abs().sum())
    torch.testing.assert_close(drawn["vector"], plain["vector"])

    # unconditional conditioning: UCG off, image conds zeroed in uc
    jc, juc = jcond.get_unconditional_conditioning(
        _batch("jax"), force_uc_zero_embeddings=["cond_frames", "cond_frames_without_noise"],
        rng=rng)
    pc, puc = pcond.get_unconditional_conditioning(
        _batch("torch"), force_uc_zero_embeddings=["cond_frames", "cond_frames_without_noise"])
    _same(pc, jc)
    _same(puc, juc)
