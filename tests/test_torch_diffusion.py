"""The port's diffusion math, conditioner and preprocessing.

Diffusion components run in float64 against independent numpy formulas of
the reference and the JAX objects (as tests/test_diffusion_math.py does for
the JAX side; rtol 1e-12, float64 round-off), and the guiders also in
float32 against JAX (rtol 1e-6).  Conditioning and preprocessing are held to the JAX package's own
functions on the same inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import rand, t
from v3d_tpu.data import preprocess as jpre
from v3d_tpu.diffusion import (
    EDMDiscretization as JDisc,
    EulerEDMSampler as JEuler,
    LinearPredictionGuider as JLinear,
    TrianglePredictionGuider as JTriangle,
)
from v3d_tpu.engines.builder import build_tiny_engine as jax_tiny_engine
from v3d_tpu.models.conditioner import ConcatTimestepEmbedderND as JConcat
from v3d_tpu_torch.data import preprocess as ppre
from v3d_tpu_torch.diffusion import (
    Denoiser,
    EDMDiscretization,
    EulerEDMSampler,
    LinearPredictionGuider,
    TrianglePredictionGuider,
    VScalingWithEDMcNoise,
)
from v3d_tpu_torch.diffusion.guidance import _prepare_cfg_inputs
from v3d_tpu_torch.engines.builder import build_tiny_engine
from v3d_tpu_torch.models.conditioner import (
    ConcatTimestepEmbedderND,
    repeat_cond_per_frame,
)

F64 = dict(rtol=1e-12, atol=1e-12)


def test_vscaling_edm_cnoise_float64():
    sig = np.array([0.002, 0.1, 1.0, 10.0, 700.0])
    c_skip, c_out, c_in, c_noise = VScalingWithEDMcNoise()(torch.tensor(sig))
    np.testing.assert_allclose(c_skip.numpy(), 1 / (sig**2 + 1), **F64)
    np.testing.assert_allclose(c_out.numpy(), -sig / np.sqrt(sig**2 + 1), **F64)
    np.testing.assert_allclose(c_in.numpy(), 1 / np.sqrt(sig**2 + 1), **F64)
    np.testing.assert_allclose(c_noise.numpy(), 0.25 * np.log(sig), **F64)


@pytest.mark.parametrize("n", [2, 25])
def test_edm_discretization_matches_jax(n):
    got = EDMDiscretization(sigma_max=700.0)(n)
    ref = JDisc(sigma_max=700.0)(n)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(EDMDiscretization()(5, flip=True),
                                  JDisc()(5, flip=True))


def test_denoiser_preconditioning_float64():
    x = rand((4, 3, 3, 2), 0).astype(np.float64)
    sig = np.array([0.5, 1.0, 2.0, 5.0])
    seen = {}

    def net(xin, c_noise, cond):
        seen["c_noise"] = c_noise
        return xin * 2.0

    out = Denoiser(VScalingWithEDMcNoise())(net, t(x), t(sig), {})
    s = sig[:, None, None, None]
    ref = x / np.sqrt(s**2 + 1) * 2.0 * (-s / np.sqrt(s**2 + 1)) + x / (s**2 + 1)
    np.testing.assert_allclose(out.numpy(), ref, **F64)
    np.testing.assert_allclose(seen["c_noise"].numpy(), 0.25 * np.log(sig), **F64)


def test_cfg_inputs_order_is_uncond_then_cond():
    x, s = torch.ones(2, 3), torch.ones(2)
    c = {"crossattn": torch.ones(2, 4), "vector": torch.ones(2, 5), "num": 18,
         "rgb": torch.ones(1)}
    uc = {"crossattn": torch.zeros(2, 4), "vector": torch.zeros(2, 5), "num": 18}
    x2, s2, cc = _prepare_cfg_inputs(x, s, c, uc)
    assert x2.shape == (4, 3) and s2.shape == (4,) and "rgb" not in cc
    assert cc["crossattn"][:2].sum() == 0 and cc["crossattn"][2:].min() == 1
    assert cc["num"] == 18


@pytest.mark.parametrize("kind", ["linear", "triangle"])
def test_frame_guiders_match_jax_and_numpy(kind):
    tt, b = 6, 2
    port_cls, jax_cls = {"linear": (LinearPredictionGuider, JLinear),
                         "triangle": (TrianglePredictionGuider, JTriangle)}[kind]
    port, jref = port_cls(4.0, tt, 1.5), jax_cls(4.0, tt, 1.5)
    np.testing.assert_array_equal(port.frame_scales(), jref.frame_scales())
    x = rand((2 * b * tt, 3, 2), 1).astype(np.float64)
    out = port(t(x), 1.0).numpy()
    xu, xc = x[:b * tt].reshape(b, tt, 3, 2), x[b * tt:].reshape(b, tt, 3, 2)
    sc = port.frame_scales().astype(np.float64)[None, :, None, None]
    np.testing.assert_allclose(out, (xu + sc * (xc - xu)).reshape(b * tt, 3, 2), **F64)
    np.testing.assert_allclose(port(t(x.astype(np.float32)), 1.0).numpy(),
                               np.asarray(jref(jnp.asarray(x, jnp.float32), 1.0)),
                               rtol=1e-6, atol=1e-6)


def _fake_denoise(x, sigma):
    return x * (0.9 / (1.0 + 0.1 * sigma))


def test_euler_sampler_float64_loop_and_jax():
    """The Euler loop, with CFG doubling through the linear guider and a
    closed-form denoiser, against a numpy float64 port of the reference
    update and against the JAX scan sampler in float64; in float32 against
    the float64 loop (rtol 1e-5: x reaches 80x its start at sigma_max)."""
    tt = 3
    x0 = rand((tt, 2, 2, 1), 2)
    guider = LinearPredictionGuider(2.0, tt, 1.0)
    sampler = EulerEDMSampler(EDMDiscretization(sigma_max=80.0), 6, guider)
    calls = []

    def denoiser(x, s, c):
        calls.append(x.shape[0])
        return _fake_denoise(x, s.reshape(-1, 1, 1, 1))

    got = sampler(denoiser, t(x0).double(), {}, {}).numpy()
    sig = EDMDiscretization(sigma_max=80.0)(6).astype(np.float64)
    x = x0.astype(np.float64) * np.sqrt(1 + sig[0] ** 2)
    for i in range(6):
        d = (x - _fake_denoise(x, sig[i])) / sig[i]
        x = x + (sig[i + 1] - sig[i]) * d
    np.testing.assert_allclose(got, x, rtol=1e-12, atol=1e-12)
    assert calls == [2 * tt] * 6  # CFG-doubled batch at every step

    # the JAX scan sampler in float64 (as tests/test_diffusion_math.py runs
    # it; its float32 scan drifts ~1e-3 from float64 here, the port's ~1e-7)
    jsampler = JEuler(discretization=JDisc(sigma_max=80.0), num_steps=6,
                      guider=JLinear(2.0, tt, 1.0))
    with jax.enable_x64(True):
        ref = jsampler(lambda x, s, c: _fake_denoise(x, s.reshape(-1, 1, 1, 1)),
                       jnp.asarray(x0, jnp.float64), {}, {},
                       rng=jax.random.PRNGKey(0))
        ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, **F64)
    got32 = sampler(denoiser, t(x0), {}, {}).numpy()
    np.testing.assert_allclose(got32, x, rtol=1e-5, atol=1e-5)


# float32 sinusoids of arguments up to 300 rad: one ulp of the argument is
# 3e-5, so the two frameworks' embeddings agree to ~3e-5 there
EMB_TOL = dict(rtol=1e-4, atol=1e-4)


def test_concat_timestep_embedder_matches_jax():
    x = np.array([[1.0, 300.0, 0.02], [6.0, 127.0, 0.0]], np.float32)
    ref = JConcat(256)(jnp.asarray(x))
    got = ConcatTimestepEmbedderND(256)(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **EMB_TOL)


def test_build_cond_matches_jax_engine():
    """GeneralConditioner routing, force-zero uc and the per-frame repeat,
    through both engines' build_cond."""
    clip_emb, cond_frames = rand((1, 1, 64), 3), rand((1, 8, 8, 4), 4)
    port_engine = build_tiny_engine(num_frames=4, device="cpu")
    jax_engine = jax_tiny_engine(num_frames=4)
    c, uc = port_engine.build_cond(t(clip_emb), t(cond_frames), 1, 300, 0.02)
    jc_, juc = jax_engine.build_cond(jnp.asarray(clip_emb), jnp.asarray(cond_frames),
                                     1, 300, 0.02)
    for port_d, jax_d in ((c, jc_), (uc, juc)):
        assert set(port_d) == set(jax_d) == {"crossattn", "concat", "vector"}
        for k in port_d:
            np.testing.assert_allclose(port_d[k].numpy(), np.asarray(jax_d[k]),
                                       **EMB_TOL)
    assert float(uc["crossattn"].abs().sum()) == 0 and float(uc["concat"].abs().sum()) == 0
    rep = repeat_cond_per_frame({"concat": torch.arange(2.0)[:, None]}, 3)
    assert rep["concat"].flatten().tolist() == [0, 0, 0, 1, 1, 1]


def _rgba(h, w, seed):
    rng = np.random.RandomState(seed)
    img = (rng.rand(h, w, 4) * 255).astype(np.uint8)
    img[..., 3] = 0
    img[h // 4: 3 * h // 4, w // 5: 4 * w // 5, 3] = 255
    return img


@pytest.mark.parametrize("case", ["rgba", "rgb_matte", "no_border"])
def test_preprocess_matches_jax_without_cv2(case, monkeypatch):
    """The port never uses cv2; the JAX module falls back to the same index
    sampling when cv2 is absent, so patch it away there."""
    monkeypatch.setattr(jpre, "cv2", None)
    img = _rgba(90, 70, 5)
    kw = dict(border_ratio=0.3, resolution=64)
    if case == "rgb_matte":
        img = img[..., :3].copy()
        img[:10] = 255  # a white band the luminance matte removes
        kw["remove_bg"] = jpre.luminance_matte
    if case == "no_border":
        kw["border_ratio"] = 0.0
    ref = jpre.preprocess_image(img, **kw)
    kw.pop("remove_bg", None)
    got = ppre.preprocess_image(img, **kw)
    assert got.shape == (64, 64, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
