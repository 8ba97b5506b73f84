"""FLUX.1 in the port (``models/flux.py``, the flow pieces of ``diffusion/``,
``ImageDiffusionEngine``'s guidance and shift) against the plain reference
(``portbench/reference/flux.py``) at toy widths in float32 on the CPU, on
the same seeded weights: hidden 128, 2 heads of 64, RoPE axes 16 / 24 / 24,
2 double and 2 single blocks, an 8x8 latent (16 patches), 7 text tokens.

Tolerances: the port and the reference compute the same float32 formulas
(another order in places: the attention's einsum against blocked matmuls,
RoPE on another layout), so outputs agree to ~1e-6 relative; the bound is
1e-5 (the relative RMS gap, or max |a - b| over max |b|).  A 3-step sample
and its decode: 1e-5 on the latents, and the [0, 1] images within 1e-5.

Also here: the UNets' attention routes and ``k1_sites`` as they were, and
the EDM and DDPM samplers' start scale bit for bit.  On the card (``gpu``):
K10 affine-free at Flux's (4608, 3072) and K9 at its (1, 24, 4608, 128):

    python -m pytest tests/test_torch_flux.py --noconftest -o addopts= -q -m gpu
"""

import math

import numpy as np
import pytest
import torch

from portbench.bench import manifest
from portbench.bench.seeded import fill_seeded_
from portbench.reference import flux as ref
from v3d_tpu_torch import diffusion as D
from v3d_tpu_torch.models import flux
from v3d_tpu_torch.utils import trace

TINY = dict(in_channels=64, vec_in_dim=32, context_in_dim=64, hidden_size=128,
            mlp_ratio=4.0, num_heads=2, depth=2, depth_single_blocks=2,
            axes_dim=(16, 24, 24))
TOL = 1e-5


def _rel(a, b):
    return float((a - b).detach().norm() / b.detach().norm())


def _pair(seed=3):
    """The port's and the reference's tiny transformer on one set of
    seeded weights, the RMSNorm scales around 1 (the seeded fill draws them
    around 0, which would flatten the attention)."""
    port = flux.Flux(**TINY).eval()
    fill_seeded_(port, seed)
    with torch.no_grad():
        for name, p in port.named_parameters():
            if name.endswith(".scale"):
                p.add_(1.0)
    plain = ref.Flux(**TINY)
    plain.load_state_dict(port.state_dict())
    return port, plain


def _inputs(n=1, h=8, w=8, tokens=7, seed=5):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(n, 16, h, w, generator=g), torch.rand(n, generator=g),
            torch.randn(n, tokens, 64, generator=g), torch.randn(n, 32, generator=g),
            torch.full((n,), 3.5))


@pytest.mark.parametrize("n,h,w,tokens", [(1, 8, 8, 7), (2, 8, 12, 5)])
def test_forward_matches_reference(n, h, w, tokens):
    port, plain = _pair()
    x, t, ctx, y, g = _inputs(n, h, w, tokens)
    with torch.no_grad():
        got = port(x, t, context=ctx, y=y, guidance=g)
        want = plain(x, t, ctx, y, g)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert _rel(got, want) <= TOL


def test_guidance_changes_the_output():
    port, _ = _pair()
    x, t, ctx, y, g = _inputs()
    with torch.no_grad():
        a = port(x, t, context=ctx, y=y, guidance=g)
        b = port(x, t, context=ctx, y=y, guidance=g + 1.0)
    assert _rel(a, b) > 1e-3
    with pytest.raises(ValueError, match="guidance"):
        port(x, t, context=ctx, y=y)


def test_rope_is_the_closed_form_rotation():
    """Each adjacent pair (x0, x1) of a head turned by pos x theta^(-2j /
    axis dim) of its axis: the port's and the reference's RoPE against a
    2x2 rotation in float64."""
    axes = (16, 24, 24)
    ids = torch.cat([torch.zeros(3, 3), flux.image_ids(2, 3, "cpu")])
    cos, sin = flux.rope_angles(ids, axes)
    rcos, rsin = ref.embed_nd(ids, axes)
    assert torch.equal(cos, rcos) and torch.equal(sin, rsin)
    x = torch.randn(1, ids.shape[0], 2, 64, dtype=torch.float64)
    angles = []
    for pos in ids.double():
        row = []
        for axis, dim in enumerate(axes):
            row += [pos[axis].item() * 10_000 ** (-2 * j / dim) for j in range(dim // 2)]
        angles.append(row)
    a = torch.tensor(angles, dtype=torch.float64)[None, :, None]       # (1, L, 1, 32)
    x0, x1 = x[..., 0::2], x[..., 1::2]
    want = torch.empty_like(x)
    want[..., 0::2] = torch.cos(a) * x0 - torch.sin(a) * x1
    want[..., 1::2] = torch.sin(a) * x0 + torch.cos(a) * x1
    got = flux.apply_rope(x.float(), cos, sin).double()
    assert float((got - want).abs().max()) <= 1e-5
    other = ref.apply_rope(x.float().transpose(1, 2), cos, sin).transpose(1, 2).double()
    assert float((other - want).abs().max()) <= 1e-5
    # text positions are 0: no turn
    assert torch.equal(got[:, :3].float(), x[:, :3].float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rms_norm(dtype):
    """x / sqrt(mean(x^2) + 1e-6) in float32, rounded to x's dtype, times
    the scale (layers.py ``RMSNorm``)."""
    norm = flux.RMSNorm(64).requires_grad_(False)
    norm.scale.copy_(torch.linspace(0.5, 1.5, 64))
    x = (3 * torch.randn(2, 5, 2, 64)).to(dtype)
    xf = x.double()
    want = (xf / torch.sqrt(xf.pow(2).mean(-1, keepdim=True) + 1e-6)).to(dtype)
    want = want * norm.scale.to(dtype)
    got = norm(x)
    assert got.dtype == dtype
    assert float((got.double() - want.double()).abs().max()) <= (
        1e-5 if dtype == torch.float32 else 2 ** -6)
    plain = ref.RMSNorm(64)
    plain.load_state_dict(norm.state_dict())
    assert _rel(norm(x.float()), plain(x.float())) <= 1e-6


@pytest.mark.parametrize("tokens,mu", [(4096, 1.15), (256, 0.5), (1024, 0.63)])
def test_schedule(tokens, mu):
    disc = D.ShiftedFlowDiscretization(image_tokens=tokens)
    assert disc.mu() == pytest.approx(mu, abs=1e-12)
    got = disc(28)
    want = ref.flux_sigmas(28, tokens)
    assert got.dtype == np.float32 and len(got) == 29
    assert got[0] == 1.0 and got[-1] == 0.0 and np.all(np.diff(got) < 0)
    np.testing.assert_array_equal(got, want)
    t = np.linspace(1, 0, 29)[1:-1]
    np.testing.assert_allclose(got[1:-1], math.exp(mu) / (math.exp(mu) + 1 / t - 1), rtol=1e-6)


@pytest.mark.parametrize("shape", [(1, 16, 8, 8), (2, 16, 6, 10), (1, 4, 128, 128)])
def test_pack_then_unpack_is_the_identity(shape):
    x = torch.randn(shape)
    packed = flux.pack(x)
    n, c, h, w = shape
    assert packed.shape == (n, h * w // 4, 4 * c)
    # patch (r, q), channel (c, ph, pw) is x[c, 2r + ph, 2q + pw]
    assert packed[0, 1, 5].item() == x[0, 1, 0, 3].item()
    assert torch.equal(flux.unpack(packed, h, w), x)


def test_layer_norm_without_affine():
    """The affine-free LayerNorm: no parameters, F.layer_norm's values in
    the input's dtype (the plain route here, K10's on the card)."""
    from v3d_tpu_torch.ops.layer_norm import layer_norm_f32, layer_norm_f32_plain

    x = torch.randn(6, 3072) * 4 + 1
    want = torch.nn.functional.layer_norm(x, (3072,), eps=1e-6)
    assert torch.equal(layer_norm_f32(x, None, None, 1e-6), want)
    assert torch.equal(layer_norm_f32_plain(x, None, None, 1e-6), want)
    norm = flux.LayerNormNoAffine()
    assert list(norm.parameters()) == []
    got = norm(x.bfloat16())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.nn.functional.layer_norm(
        x.bfloat16().float(), (3072,), eps=1e-6).bfloat16())


def test_flow_scaling_gives_x_minus_sigma_v_and_flux_euler():
    """D(x, t) = x - t v, and the Euler step x + (t' - t) (x - D) / t is
    BFL's img + (t_prev - t_curr) v."""
    v = torch.randn(2, 4, 4, 16)
    x = torch.randn(2, 4, 4, 16)
    sigma = torch.tensor([0.7, 0.7])
    den = D.Denoiser(scaling=D.FlowScaling())
    got = den(lambda xin, c_noise, cond: v, x, sigma, {})
    assert torch.allclose(got, x - 0.7 * v, atol=1e-6)
    seen = {}

    def network(xin, c_noise, cond):
        seen["x"], seen["t"] = xin, c_noise
        return v

    den(network, x, sigma, {})
    assert torch.equal(seen["x"], x) and torch.equal(seen["t"], sigma)
    step = x + (0.4 - 0.7) * (x - got) / 0.7
    assert torch.allclose(step, x + (0.4 - 0.7) * v, atol=1e-5)


def _flux_module():
    return manifest.load_module(manifest.PKG / "configs" / "flux1-dev.py", "flux1-dev")


def _tiny_engine_and_reference(seed=2**31 + 9):
    mod = _flux_module()
    cell = mod.tiny_cell()
    cfg = cell.config
    engine = mod.build_port(cfg, "serve", "cpu", seed, sampler={"num_steps": 3,
                                                                "resolution": 64})
    plain = mod.build_reference(cfg, "serve", "cpu", seed)
    return mod, cfg, engine, plain


def test_sample_and_decode_match_reference():
    """Three Euler steps through ``ImageDiffusionEngine.sample`` and its
    ``decode`` (z / 0.3611 + 0.1159) against the reference's flow Euler and
    decode from the same noise and conditions."""
    mod, cfg, engine, plain = _tiny_engine_and_reference()
    g = torch.Generator().manual_seed(11)
    noise = torch.randn(1, 8, 8, 16, generator=g)
    cond = {"crossattn": torch.randn(1, 7, 64, generator=g),
            "vector": torch.randn(1, 32, generator=g), "guidance": torch.full((1,), 3.5)}
    z = engine.sample(cond, None, batch=1, height=64, width=64, noise=noise)
    sigmas = mod.reference_sigmas(cfg, 3, 64)
    with torch.no_grad():
        want = plain.euler(sigmas, noise, cond)
    assert engine.shift_factor == 0.1159 and engine.latent_channels == 16
    assert _rel(z, want) <= TOL and _rel(z, noise) > 1e-2
    images = engine.decode(z)
    with torch.no_grad():
        want_images = plain.decode(z)
    assert images.shape == (1, 64, 64, 3)
    assert float((images - want_images).abs().max()) <= TOL


def test_flux_spans_and_counters():
    """Inside each ``unet.forward``: one ``flux.embed``, a ``flux.double``
    a double block and a ``flux.single`` a single block, each holding one
    ``flux.attention``, one ``flux.final``; the forward counter counts."""
    _, _, engine, _ = _tiny_engine_and_reference()
    g = torch.Generator().manual_seed(1)
    cond = {"crossattn": torch.randn(1, 7, 64, generator=g),
            "vector": torch.randn(1, 32, generator=g), "guidance": torch.full((1,), 3.5)}
    before = dict(trace.UNET_FORWARD)
    trace.take()
    with trace.recording() as got:
        engine.sample(cond, None, batch=1, height=64, width=64,
                      noise=torch.randn(1, 8, 8, 16, generator=g))
    assert trace.UNET_FORWARD["forwards"] - before["forwards"] == 3
    by_id = {s.id: s for s in got}

    def names(kind):
        return [s for s in got if s.name == kind]

    forwards = names("unet.forward")
    assert len(forwards) == 3
    assert [len(names(k)) for k in ("flux.embed", "flux.double", "flux.single",
                                    "flux.attention", "flux.final")] == [3, 6, 6, 12, 3]
    for s in names("flux.attention"):
        assert by_id[s.parent].name in ("flux.double", "flux.single")
        assert s.attrs == {"tokens": 23}
    for s in names("flux.double") + names("flux.single"):
        assert by_id[s.parent].name == "unet.forward"
    assert sorted(s.attrs["block"] for s in names("flux.single")) == [0, 0, 0, 1, 1, 1]


def test_engine_passes_guidance_only_when_given():
    """The UNets' call is as it was: no ``guidance`` keyword unless the
    condition holds one."""
    from v3d_tpu_torch.engines.image_diffusion import ImageDiffusionEngine

    calls = []

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(1))

        def forward(self, x, t, **kw):
            calls.append(sorted(kw))
            return torch.zeros_like(x)

    eng = ImageDiffusionEngine(unet=Net(), denoiser=D.Denoiser(scaling=D.FlowScaling()),
                               sampler=None)
    fn = eng._denoiser_fn()
    x = torch.zeros(1, 2, 2, 4)
    fn(x, torch.ones(1), {"crossattn": torch.zeros(1, 1, 1)})
    fn(x, torch.ones(1), {"crossattn": torch.zeros(1, 1, 1), "guidance": torch.ones(1)})
    assert calls == [["context", "y"], ["context", "guidance", "y"]]


# -- what the Flux path must not move -------------------------------------------

# (sq, sk, d, route on the (b, s, h, d) layout, route on (b, h, s, d), a K1 site):
# V3D's ds1 / ds2 / ds4 self-attention and its cross-attention, SD's ds1 / ds2
# / ds4 self-attention at 768^2, CLIP's tokens, the VAE's d = 512
UNET_SITES = [
    (4096, 4096, 64, "flash", "flash_jax", True),
    (1024, 1024, 64, "flash_jax", "flash_jax", True),
    (256, 256, 64, "xla", "xla", False),
    (4096, 1, 64, "xla", "xla", False),
    (9216, 9216, 64, "flash", "flash_jax", True),
    (2304, 2304, 64, "xla", "xla", False),
    (576, 576, 64, "xla", "xla", False),
    (257, 257, 80, "xla", "xla", False),
    (4096, 4096, 512, "xla", "xla", False),
]


@pytest.mark.parametrize("sq,sk,d,route,bhsd,k1", UNET_SITES)
def test_unet_attention_routes_and_k1_sites_unchanged(sq, sk, d, route, bhsd, k1):
    from portbench.bench.work import k1_sites
    from v3d_tpu_torch.ops.attention import attention_bhsd_route, attention_route

    assert attention_route(sq, sk, d, torch.bfloat16, True) == route
    assert attention_route(sq, sk, d, torch.bfloat16, False) == "xla"
    assert attention_bhsd_route(sq, sk, d, True) == bhsd
    site = (36, 5, sq, sk, d, sq == sk)
    assert k1_sites([site]) == ([site] if k1 else [])


@pytest.mark.parametrize("disc", [
    D.EDMDiscretization(sigma_max=700.0), D.LegacyDDPMDiscretization(),
    D.EDMDiscretization(), "sliced"], ids=["edm700", "ddpm", "edm80", "sliced"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_edm_and_ddpm_start_scale_unchanged(disc, dtype):
    """``prepare`` scales the noise by sqrt(1 + sigma0^2) in x's dtype, the
    formula of sampling.py:50, bit for bit; a flow schedule starts at the
    noise."""
    from v3d_tpu_torch.diffusion.discretize import SlicedDiscretization

    if disc == "sliced":
        disc = SlicedDiscretization(base=D.LegacyDDPMDiscretization(), skip=10)
    sampler = D.EulerEDMSampler(discretization=disc, num_steps=25)
    x = torch.randn(2, 8, 8, 4).to(dtype)
    got, sigmas_np, sigmas = sampler.prepare(x)
    want = x * torch.sqrt(1.0 + sigmas[0].to(x.dtype) ** 2)
    assert torch.equal(got, want) and not torch.equal(got, x)
    flow = D.EulerEDMSampler(discretization=D.ShiftedFlowDiscretization(), num_steps=25)
    assert torch.equal(flow.prepare(x)[0], x)


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see module docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_k10_affine_free_at_flux_width(dev):
    """K10's generic path at (4608, 3072), no affine, eps 1e-6, against the
    plain formula: within one bf16 ulp (floor 2^-10), < 0.1% of elements
    apart (``tests/test_torch_kernels_gpu.py``'s bound)."""
    from v3d_tpu_torch.ops import LAUNCHES
    from v3d_tpu_torch.ops.layer_norm import layer_norm_f32_plain

    x = (torch.randn(1, 4608, 3072, device=dev) * 3 + 0.5).bfloat16()
    before = LAUNCHES["layer_norm"]
    got = flux.LayerNormNoAffine()(x)
    torch.cuda.synchronize()
    assert LAUNCHES["layer_norm"] == before + 1
    want = layer_norm_f32_plain(x, None, None, 1e-6)
    diff = (got.float() - want.float()).abs()
    big = torch.maximum(got.float().abs(), want.float().abs()).clamp(min=2.0 ** -10)
    _, e = torch.frexp(big)
    assert bool((diff <= torch.ldexp(torch.ones_like(big), e - 8)).all()), float(diff.max())
    assert float((diff > 0).float().mean()) < 1e-3


@pytest.mark.gpu
def test_k9_at_flux_joint_attention(dev):
    """K9 at (1, 24, 4608, 128) through the Flux route (``flash_attention``
    on the (b, s, h, d) layout) against ``flash_attn_fwd_wide_plain`` on
    the same bf16 inputs in f32: PSNR >= 40 dB, the kernels' bf16 bound,
    and the RMS gap within 1e-2 of the output's RMS.  q is scaled so the
    scores have std 4: each row's softmax is peaked on a few of the 4,608
    keys (random unit q and k would give a near-uniform one, whose output
    is near zero), and the output's RMS is held above 0.3 to show it."""
    from v3d_tpu_torch.ops import LAUNCHES
    from v3d_tpu_torch.ops.flash_attention import flash_attention, flash_attn_fwd_wide_plain

    g = torch.Generator(device=dev).manual_seed(9)
    q, k, v = (torch.randn(1, 4608, 24, 128, device=dev, generator=g) * c
               for c in (4.0, 1.0, 1.0))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    before = LAUNCHES["flash_attn_fwd_wide"]
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attn_fwd_wide"] == before + 1
    want = flash_attn_fwd_wide_plain(*(t.float().transpose(1, 2) for t in (q, k, v)))
    want = want.transpose(1, 2)
    rms = float(want.pow(2).mean().sqrt())
    mse = float(((got.float() - want) ** 2).mean())
    assert rms > 0.3, rms
    assert 10 * math.log10(float(want.abs().max()) ** 2 / mse) >= 40.0
    assert math.sqrt(mse) <= 1e-2 * rms, (math.sqrt(mse), rms)
