"""The port's diffusion library (v3d_tpu_torch/diffusion) against the JAX
package on the CPU, in float32, on the same numpy inputs.

Tolerances:
- discretizations (EDM, legacy DDPM, sliced): equal, float32 for float32
  (both are the same float64 numpy code rounded once);
- scalings: rel 1e-6 (one or two float32 ops each);
- ``DiscreteDenoiser``: indices equal (ties to the lower index on both
  sides), output rel 1e-6; ``DiscreteSampling`` on the JAX indices: equal;
- each sampler against the JAX one on a closed-form denoiser (the posterior
  mean of unit-Gaussian data, x / (1 + sigma^2), plus a cond-dependent term
  so that the guiders' two halves differ), with the JAX keys' draws handed
  in: max |port - JAX| <= 1e-5 max |JAX| (float32 rounding of ~10 ops a step
  over 5 steps, with exp / log / expm1 differing by an ulp between XLA and
  PyTorch).  The JAX samplers run op by op (``jax.disable_jit``): XLA's
  CPU compile of the whole ``lax.scan`` lands ~1.4e-4 (relative) from a
  float64 evaluation on the 5-step Euler case, op by op 2e-6, the port 4e-7;
- the network calls: Heun and DPM++(2S) ancestral 2n - 1, the others n.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v3d_tpu.diffusion import denoise as jden
from v3d_tpu.diffusion import discretize as jdisc
from v3d_tpu.diffusion import guidance as jguid
from v3d_tpu.diffusion import sampling as jsamp
from v3d_tpu.diffusion import scaling as jscal
from v3d_tpu.diffusion import sigma_sampling as jsig
from v3d_tpu_torch.diffusion import denoise as pden
from v3d_tpu_torch.diffusion import discretize as pdisc
from v3d_tpu_torch.diffusion import guidance as pguid
from v3d_tpu_torch.diffusion import sampling as psamp
from v3d_tpu_torch.diffusion import scaling as pscal
from v3d_tpu_torch.diffusion import sigma_sampling as psig

torch.set_num_threads(1)


def _disc(mod, kind):
    if kind == "edm700":
        return mod.EDMDiscretization(sigma_max=700.0)
    if kind == "edm":
        return mod.EDMDiscretization()
    if kind == "legacy":
        return mod.LegacyDDPMDiscretization()
    if kind == "sliced_edm":
        return mod.SlicedDiscretization(base=mod.EDMDiscretization(sigma_max=700.0),
                                        skip=10)
    return mod.SlicedDiscretization(base=mod.LegacyDDPMDiscretization(), skip=3)


@pytest.mark.parametrize("kind", ["edm700", "edm", "legacy", "sliced_edm",
                                  "sliced_legacy"])
def test_discretizations_equal(kind):
    for n in (1, 2, 15, 25, 997):
        for zero in (True, False):
            for flip in (False, True):
                want = _disc(jdisc, kind)(n, do_append_zero=zero, flip=flip)
                got = _disc(pdisc, kind)(n, do_append_zero=zero, flip=flip)
                assert got.dtype == want.dtype == np.float32
                np.testing.assert_array_equal(got, want, err_msg=f"{n} {zero} {flip}")
    want = jdisc.make_beta_schedule_linear(1000, 0.00085, 0.012)
    np.testing.assert_array_equal(pdisc.make_beta_schedule_linear(1000, 0.00085, 0.012),
                                  want)
    assert np.array_equal(pdisc.LegacyDDPMDiscretization()(1000, False),
                          jdisc.LegacyDDPMDiscretization()(1000, False))
    with pytest.raises(ValueError):
        pdisc.LegacyDDPMDiscretization().get_sigmas(1001)


@pytest.mark.parametrize("name", ["EDMScaling", "EpsScaling", "VScaling",
                                  "VScalingWithEDMcNoise"])
def test_scalings(name):
    sigma = np.exp(np.random.RandomState(0).uniform(-6, 7, (7, 1, 1, 1))).astype(np.float32)
    want = getattr(jscal, name)()(jnp.asarray(sigma))
    got = getattr(pscal, name)()(torch.from_numpy(sigma))
    for w, g in zip(want, got):
        w = np.broadcast_to(np.asarray(w), g.shape)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0)


class _Steps:
    """A numpy discretization both packages accept: levels 0.5, 1, 1.5, ...
    so that a sigma half-way between two of them is an exact tie."""

    def __call__(self, n, do_append_zero=True, flip=False):
        s = (np.arange(n, dtype=np.float32) + 1.0) * 0.5
        s = np.concatenate([s, [0.0]]).astype(np.float32) if do_append_zero else s
        return s[::-1].copy() if flip else s


def _linear_network(lib):
    def network(x, c_noise, cond):
        t = c_noise.astype(jnp.float32) if lib is jnp else c_noise.float()
        return 0.7 * x + 0.01 * t.reshape((-1,) + (1,) * (x.ndim - 1))
    return network


@pytest.mark.parametrize("disc", ["legacy", "steps"])
@pytest.mark.parametrize("scaling", ["EpsScaling", "VScaling"])
def test_discrete_denoiser(disc, scaling):
    rs = np.random.RandomState(1)
    if disc == "steps":
        jd = pd = _Steps()
        num_idx = 40
        sigma = np.array([0.75, 1.25, 3.0, 7.3, 19.75, 0.51, 20.2, 0.2], np.float32)
    else:
        jd, pd = jdisc.LegacyDDPMDiscretization(), pdisc.LegacyDDPMDiscretization()
        num_idx = 1000
        sigma = np.exp(rs.uniform(-3, 4.5, 8)).astype(np.float32)
    x = rs.randn(8, 4, 4, 3).astype(np.float32)
    jden_ = jden.DiscreteDenoiser(scaling=getattr(jscal, scaling)(), discretization=jd,
                                  num_idx=num_idx)
    pden_ = pden.DiscreteDenoiser(scaling=getattr(pscal, scaling)(), discretization=pd,
                                  num_idx=num_idx)
    j_idx = np.asarray(jden_.sigma_to_idx(jnp.asarray(sigma)))
    p_idx = pden_.sigma_to_idx(torch.from_numpy(sigma)).numpy()
    np.testing.assert_array_equal(p_idx, j_idx)
    if disc == "steps":  # the four exact ties went to the lower index
        levels = pd(num_idx, do_append_zero=False, flip=True)
        for i in range(4):
            d = np.abs(levels - sigma[i])
            assert p_idx[i] == np.flatnonzero(d == d.min())[0]
    np.testing.assert_array_equal(pden_.quantize_sigma(torch.from_numpy(sigma)).numpy(),
                                  np.asarray(jden_.quantize_sigma(jnp.asarray(sigma))))
    want = np.asarray(jden_(_linear_network(jnp), jnp.asarray(x), jnp.asarray(sigma), {}))
    got = pden_(_linear_network(torch), torch.from_numpy(x), torch.from_numpy(sigma), {})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    # built once per device
    assert pden_.sigmas("cpu") is pden_.sigmas(torch.device("cpu"))


def test_discrete_sampling_on_jax_indices():
    key = jax.random.PRNGKey(3)
    want = np.asarray(jsig.DiscreteSampling(
        discretization=jdisc.LegacyDDPMDiscretization())(key, 64))
    idx = torch.from_numpy(np.asarray(jax.random.randint(key, (64,), 0, 1000)).astype(np.int64))
    got = psig.DiscreteSampling(discretization=pdisc.LegacyDDPMDiscretization())(64, idx=idx)
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = psig.DiscreteSampling(discretization=pdisc.LegacyDDPMDiscretization())(
        16, generator=torch.Generator().manual_seed(0))
    levels = pdisc.LegacyDDPMDiscretization()(1000, do_append_zero=False)
    assert drawn.shape == (16,) and np.isin(drawn.numpy(), levels).all()


SAMPLERS = {
    "euler": dict(),
    "euler_churn": dict(s_churn=2.0),
    "heun": dict(),
    "euler_ancestral": dict(eta=1.0),
    "dpmpp2s_ancestral": dict(eta=1.0),
    "dpmpp2m": dict(),
    "lms": dict(order=3),
}
CLASS = {"euler": "EulerEDMSampler", "euler_churn": "EulerEDMSampler",
         "heun": "HeunEDMSampler", "euler_ancestral": "EulerAncestralSampler",
         "dpmpp2s_ancestral": "DPMPP2SAncestralSampler",
         "dpmpp2m": "DPMPP2MSampler", "lms": "LinearMultistepSampler"}
T, N_STEPS = 4, 5


def _guider(mod, name):
    if name == "identity":
        return mod.IdentityGuider()
    if name == "vanilla":
        return mod.VanillaCFG(scale=2.5)
    return mod.LinearPredictionGuider(max_scale=3.5, num_frames=T, min_scale=1.0)


def _sampler(mod_s, mod_d, mod_g, name, guider):
    return getattr(mod_s, CLASS[name])(
        discretization=mod_d.EDMDiscretization(sigma_max=80.0), num_steps=N_STEPS,
        guider=_guider(mod_g, guider), **SAMPLERS[name])


def _closed_form(lib, calls=None):
    """The posterior mean of unit-Gaussian data, x / (1 + s^2), moved by
    0.2 * concat so that the cond and uncond halves differ."""
    def denoiser(x, s, c):
        if calls is not None:
            calls.append(1)
        s = s.reshape((-1,) + (1,) * (x.ndim - 1))
        return x / (1.0 + s * s) + 0.2 * c["concat"] + 0.01 * c["vector"][:, :1, None, None]
    return denoiser


def _conds(rs):
    c = {"concat": rs.randn(T, 6, 6, 4), "vector": rs.randn(T, 8)}
    uc = {"concat": rs.randn(T, 6, 6, 4) * 0.1, "vector": np.zeros((T, 8))}
    return ({k: v.astype(np.float32) for k, v in c.items()},
            {k: v.astype(np.float32) for k, v in uc.items()})


@pytest.mark.parametrize("guider", ["identity", "vanilla", "linear"])
@pytest.mark.parametrize("name", list(SAMPLERS))
def test_sampler_matches_jax(name, guider):
    rs = np.random.RandomState(2)
    x = rs.randn(T, 6, 6, 4).astype(np.float32)
    c, uc = _conds(rs)
    rng = jax.random.PRNGKey(11)
    js = _sampler(jsamp, jdisc, jguid, name, guider)
    with jax.disable_jit():
        want = np.asarray(js(_closed_form(jnp), jnp.asarray(x),
                             {k: jnp.asarray(v) for k, v in c.items()},
                             {k: jnp.asarray(v) for k, v in uc.items()}, rng=rng))
    # the JAX samplers split rng into one key a step and draw at every step
    noises = [torch.from_numpy(np.array(jax.random.normal(k, x.shape, jnp.float32)))
              for k in jax.random.split(rng, N_STEPS)]
    ps = _sampler(psamp, pdisc, pguid, name, guider)
    got = ps(_closed_form(torch), torch.from_numpy(x),
             {k: torch.from_numpy(v) for k, v in c.items()},
             {k: torch.from_numpy(v) for k, v in uc.items()}, noises=noises)
    assert np.isfinite(want).all()
    scale = np.abs(want).max()
    assert scale > 0.1
    assert np.abs(got.numpy() - want).max() <= 1e-5 * scale, np.abs(got.numpy() - want).max()


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_network_calls(name):
    calls = []
    rs = np.random.RandomState(3)
    c, uc = _conds(rs)
    ps = _sampler(psamp, pdisc, pguid, name, "linear")
    out = ps(_closed_form(torch, calls), torch.from_numpy(rs.randn(T, 6, 6, 4).astype(np.float32)),
             {k: torch.from_numpy(v) for k, v in c.items()},
             {k: torch.from_numpy(v) for k, v in uc.items()},
             generator=torch.Generator().manual_seed(0))
    two_stage = name in ("heun", "dpmpp2s_ancestral")
    assert len(calls) == (2 * N_STEPS - 1 if two_stage else N_STEPS)
    assert torch.isfinite(out).all()


def test_helpers_match_jax():
    rs = np.random.RandomState(4)
    x, den = rs.randn(2, 3, 3, 2).astype(np.float32), rs.randn(2, 3, 3, 2).astype(np.float32)
    sigma = np.float32(3.7)
    np.testing.assert_allclose(
        psamp.to_d(torch.from_numpy(x), torch.tensor(sigma), torch.from_numpy(den)).numpy(),
        np.asarray(jsamp.to_d(jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(den))),
        rtol=1e-6)
    for s_from, s_to, eta in ((80.0, 20.0, 1.0), (5.0, 0.0, 1.0), (3.0, 1.0, 0.5), (3.0, 1.0, 0.0)):
        want = jsamp.get_ancestral_step(jnp.float32(s_from), jnp.float32(s_to), eta)
        got = psamp.get_ancestral_step(torch.tensor(s_from), torch.tensor(s_to), eta)
        host = psamp.get_ancestral_step(np.float32(s_from), np.float32(s_to), eta)
        for w, g, h in zip(want, got, host):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-6)
            np.testing.assert_allclose(float(h), float(w), rtol=1e-6)
    # IdentityGuider is the default guider, as in the JAX samplers
    assert isinstance(psamp.HeunEDMSampler().guider, pguid.IdentityGuider)
    assert isinstance(psamp.EulerEDMSampler().guider, pguid.IdentityGuider)
