"""The port's LPIPS (v3d_tpu_torch/metrics/lpips.py) and its users against
the JAX package's, on the CPU in float32, with one seeded .npz in the JAX
layout (``chip_smoke.write_seeded_lpips``) driving both sides:

- distances and input gradients, max relative error <= 1e-5, including an
  all-black pair and a file whose relu5_3 tap is 0 everywhere (eps inside
  the square root, as the JAX package: finite gradients on both sides);
- ``utils.precision.conv2d_f32`` (LPIPS's and SSIM's convolutions) equal
  to ``F.conv2d`` on the CPU;
- ``load_lpips`` (None without the file, ``$V3D_TPU_LPIPS_WEIGHTS``) and
  ``convert_lpips_torch`` against the JAX converter;
- one 3DGS step with ``lambda_lpips`` 2.0 against the JAX trainer's step
  and the port's step with LPIPS in float64 (loss rel 1e-4 as
  test_torch_gs_trainer.py; gradients see ``GS_GRAD_REL``), and the two
  renders' backward passes on one image gradient;
- refine steps with ``lambda_lpips`` 1.0 at the shipped lr 1e-3
  (test_torch_refine.py's sphere and tolerances);
- an autoencoder generator step with LPIPS in its reconstruction term.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from test_torch_ae import TINY as AE_TINY, _jax_trainer
from test_torch_gs_trainer import CFG as GS_CFG, _frames
from test_torch_refine import CFG as REFINE_CFG, sphere  # noqa: F401  (fixture)
from v3d_tpu.data.cameras import orbit_cameras as jorbit
from v3d_tpu.gs.trainer import GSTrainConfig as JGSConfig, GSTrainer as JGSTrainer
from v3d_tpu.meshops.mesh import Mesh as JMesh
from v3d_tpu.meshops.refine import RefineConfig as JRefineConfig
from v3d_tpu.meshops.refine import TextureRefiner as JRefiner
from v3d_tpu.metrics import lpips as jl
from v3d_tpu_torch.core.convert import ae_trainer_state_from_jax, trainer_state_from_jax
from v3d_tpu_torch.data.cameras import orbit_cameras
from v3d_tpu_torch.engines.ae_trainer import AETrainConfig, AutoencoderTrainer
from v3d_tpu_torch.gs.losses import ssim
from v3d_tpu_torch.gs.trainer import GSTrainConfig, GSTrainer
from v3d_tpu_torch.meshops.mesh import Mesh
from v3d_tpu_torch.meshops.refine import RefineConfig, TextureRefiner
from v3d_tpu_torch.metrics import lpips as pl
from v3d_tpu_torch.models import vae as PVAE
from v3d_tpu_torch.utils.precision import conv2d_f32

RTOL = 1e-5
# a 3DGS step's gradients with the LPIPS term, each field against its
# largest element.  The render's flat background puts exact ties in many
# of LPIPS's 2x2 max-pool windows; each side's float32 rounding breaks them
# its own way and routes the window's gradient to another pixel (ROADMAP
# C17), so the image gradients the two packages hand their renderers
# differ, and the gaussians' gradients, sums over the pixels each covers,
# differ (the JAX step's from the float64 one's: measured 8.9e-5 to 6.5e-4).
# Given one image gradient, the two renders' backward passes agree to
# RENDER_VJP_REL (measured <= 1.2e-6); the port's float32 step holds
# test_torch_gs_trainer.py's 1e-4 against the same step with LPIPS in
# float64 (measured 5.5e-6 to 3.2e-5).  Without the term every field's
# gradient moves by >= 0.35 of its largest.
GS_GRAD_REL = 1e-3
GS_GRAD_REL_PORT = 1e-4
RENDER_VJP_REL = 1e-5


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    root = tmp_path_factory.mktemp("lpips")
    return {"live": chip_smoke.write_seeded_lpips(str(root / "vgg.npz"), 0),
            "dead": chip_smoke.write_seeded_lpips(str(root / "dead.npz"), 1, dead_tap=True)}


def _images(seed, n=2, hw=32):
    rs = np.random.RandomState(seed)
    return rs.rand(n, hw, hw, 3).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


PAIRS = {
    "random": lambda: (_images(0), _images(1)),
    "odd_size": lambda: (_images(2, hw=35), _images(3, hw=35)),
    "black_vs_noise": lambda: (np.zeros((2, 32, 32, 3), np.float32), _images(4)),
    "all_black": lambda: (np.zeros((1, 32, 32, 3), np.float32),) * 2,
}


def _port(params, x, y):
    xt = torch.from_numpy(x).to(params["lin0"].dtype).requires_grad_()
    d = pl.lpips_distance(params, xt, torch.from_numpy(y).to(xt.dtype))
    d.sum().backward()
    return d.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("which", ["live", "dead"])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_distance_and_gradient_match_jax(weights, which, pair):
    """Distances: port against JAX, both float32.  Input gradients: each
    float32 side against the port in float64 (the exact formula's value),
    since the two float32 sides' roundings add up: the gradient crosses 13
    convolutions and lands ~5e-6 of its largest element from float64 on
    either side.  A 2x2 pool window holding two values within float32
    rounding (one at 37^2 with these seeds, 9e-8 apart) sends the gradient
    to the other pixel on whichever side rounds it over (ROADMAP C17); at
    the odd size here, 35^2, both sides match float64."""
    x, y = PAIRS[pair]()
    with np.load(weights[which]) as data:
        jparams = {k: jnp.asarray(v) for k, v in data.items()}
        params = pl.lpips_params(dict(data), "cpu")
    params64 = {k: v.double() for k, v in params.items()}
    want = np.asarray(jl.lpips_distance(jparams, jnp.asarray(x), jnp.asarray(y)))
    jgrad = np.asarray(jax.grad(lambda a: jnp.sum(jl.lpips_distance(
        jparams, a, jnp.asarray(y))))(jnp.asarray(x)))
    got, grad = _port(params, x, y)
    _, grad64 = _port(params64, x, y)
    assert got.shape == want.shape == (len(x),)
    assert np.isfinite(jgrad).all() and np.isfinite(grad).all()
    if pair == "all_black":
        assert np.abs(got).max() == 0.0 and want.max() == 0.0
        assert np.abs(grad).max() == 0.0
        return
    assert _rel(got, want) <= RTOL
    assert _rel(jgrad, grad64) <= RTOL and _rel(grad, grad64) <= RTOL
    if which == "dead":  # the relu5_3 tap is 0 on both images
        feats = pl.vgg_features(params, torch.from_numpy(x) * 2 - 1)
        assert float(feats[-1].abs().max()) == 0.0


@pytest.mark.parametrize("cin,cout,groups,size,pad,bias", [
    (3, 8, 1, 3, 1, True),        # a VGG conv
    (15, 15, 15, 11, 5, False),   # SSIM's depthwise window
    (6, 4, 2, 3, 0, True)])
def test_conv2d_f32_equals_conv2d_on_the_cpu(cin, cout, groups, size, pad, bias):
    """``utils.precision.conv2d_f32`` (TF32 off in forward and backward on
    the card) is ``F.conv2d`` on the CPU: outputs and every gradient bit
    for bit, and only the gradients asked for."""
    gen = torch.Generator().manual_seed(cin)
    x = torch.randn(2, cin, 13, 11, generator=gen, requires_grad=True)
    w = torch.randn(cout, cin // groups, size, size, generator=gen, requires_grad=True)
    b = torch.randn(cout, generator=gen, requires_grad=True) if bias else None
    want = torch.nn.functional.conv2d(x, w, b, padding=pad, groups=groups)
    got = conv2d_f32(x, w, b, padding=pad, groups=groups)
    assert torch.equal(got, want)
    g = torch.randn(want.shape, generator=gen)
    ins = [x, w] + ([b] if bias else [])
    for a, c in zip(torch.autograd.grad(want, ins, g), torch.autograd.grad(got, ins, g)):
        assert torch.equal(a, c)
    (gx,) = torch.autograd.grad(conv2d_f32(x, w.detach(), padding=pad, groups=groups), x, g)
    (want_gx,) = torch.autograd.grad(torch.nn.functional.conv2d(
        x, w.detach(), padding=pad, groups=groups), x, g)
    assert torch.equal(gx, want_gx)


def test_load_lpips_like_jax(weights, monkeypatch, tmp_path):
    monkeypatch.setenv("V3D_TPU_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    assert pl.load_lpips(device="cpu") is None and jl.load_lpips() is None
    monkeypatch.setenv("V3D_TPU_LPIPS_WEIGHTS", weights["live"])
    fn, jfn = pl.load_lpips(device="cpu"), jl.load_lpips()
    x, y = _images(5), _images(6)
    assert abs(float(fn(torch.from_numpy(x), torch.from_numpy(y)))
               - float(jfn(x, y))) <= RTOL * float(jfn(x, y))
    assert pl.load_lpips(str(tmp_path / "absent.npz"), device="cpu") is None


def test_convert_lpips_torch_matches_jax():
    """A torch LPIPS(VGG) state dict (net.slice*.N.* convs, lin*.model.1
    heads) -> the same arrays as the JAX converter's."""
    rs = np.random.RandomState(0)
    tv_idx = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    slices = [1, 1, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5]
    sd, cin = {}, 3
    chans = [c for c in pl.VGG_PLAN if c != "M"]
    for ti, sl, c in zip(tv_idx, slices, chans):
        w, b = rs.randn(c, cin, 3, 3), rs.randn(c)
        sd[f"net.slice{sl}.{ti}.weight"] = torch.from_numpy(w.astype(np.float32))
        sd[f"net.slice{sl}.{ti}.bias"] = torch.from_numpy(b.astype(np.float32))
        cin = c
    for li, c in enumerate((64, 128, 256, 512, 512)):
        sd[f"lin{li}.model.1.weight"] = torch.from_numpy(rs.rand(1, c, 1, 1).astype(np.float32))
    ours, ref = pl.convert_lpips_torch(sd), jl.convert_lpips_torch(sd)
    assert sorted(ours) == sorted(ref) and len(ours) == 31
    assert all(np.array_equal(ours[k], ref[k]) for k in ref)


def test_gs_step_with_lpips_matches_jax(weights):
    """One step with lambda_lpips 2.0: the JAX trainer's, the port's, the
    port's with LPIPS in float64 (``exact``) and the port's without LPIPS
    (``plain``), from one state.  Each float32 side's gradients against
    ``exact`` (see ``GS_GRAD_REL``); the LPIPS term moves every field's
    gradient by far more than those tolerances; and the two renders'
    backward passes on the port's image gradient agree to RENDER_VJP_REL."""
    frames = _frames()
    cfg = dict(GS_CFG, lambda_lpips=2.0)
    jt = JGSTrainer(jorbit(4, resolution=64, images=frames), JGSConfig(**cfg),
                    num_pts=200, capacity=260, seed=0, lpips_fn=jl.load_lpips(weights["live"]))
    with np.load(weights["live"]) as data:
        params64 = {k: v.double() for k, v in pl.lpips_params(dict(data), "cpu").items()}

    def lpips64(x, y):
        return pl.lpips_distance(params64, x.double(), y.double()).mean().float()

    def port_trainer(c, lpips_fn):
        return GSTrainer(orbit_cameras(4, resolution=64, images=frames), GSTrainConfig(**c),
                         num_pts=200, capacity=260, seed=0, lpips_fn=lpips_fn, device="cpu")

    trainers = {"port": port_trainer(cfg, pl.load_lpips(weights["live"], device="cpu")),
                "exact": port_trainer(cfg, lpips64), "plain": port_trainer(GS_CFG, None)}
    state = jt.capture()
    rs = np.random.RandomState(1)
    params = dict(state["params"])
    params["scaling"] = params["scaling"] + jnp.asarray(
        0.3 * rs.randn(*params["scaling"].shape), jnp.float32)
    params["rotation"] = jnp.asarray(rs.randn(*params["rotation"].shape), jnp.float32)
    jt.restore({**state, "params": params})
    # copies: the JAX step donates its buffers
    start = jax.tree_util.tree_map(lambda a: np.array(a) if isinstance(a, jax.Array) else a,
                                   jt.capture())
    for tr in trainers.values():
        tr.restore(trainer_state_from_jax(start))
    jloss = float(jt.train_iter(1)["loss"])
    loss = {name: float(tr.train_iter(1)["loss"]) for name, tr in trainers.items()}
    assert loss["port"] == pytest.approx(jloss, rel=1e-4)
    assert loss["exact"] == pytest.approx(jloss, rel=1e-4)
    assert loss["port"] > loss["plain"]   # the term is there
    jstate = trainer_state_from_jax(jt.capture())
    for k in ("xyz", "f_dc", "scaling", "rotation", "opacity"):
        exact = trainers["exact"].params[k].grad.numpy()
        scale = np.abs(exact).max()
        assert scale > 0, k
        jax_grad = jstate["adam"][k]["exp_avg"] / 0.1
        assert np.abs(jax_grad - exact).max() <= GS_GRAD_REL * scale, k
        got = trainers["port"].params[k].grad.numpy()
        assert np.abs(got - exact).max() <= GS_GRAD_REL_PORT * scale, k
        plain = trainers["plain"].params[k].grad.numpy()
        assert np.abs(plain - exact).max() >= 100 * GS_GRAD_REL * scale, k

    # the renders' backward passes on one image gradient, from the start state
    port = trainers["port"]
    port.restore(trainer_state_from_jax(start))
    port.opt.zero_grad(set_to_none=True)
    jt.restore(start)
    cam, bg = 1, torch.zeros(3)
    cap = port.alive.shape[0]
    out = port._render(cam, bg, torch.zeros(cap, 2))
    image = out.image.detach().requires_grad_()
    target = port.images[cam]
    image_loss = (1.0 - ssim(image, target)) + 2.0 * port.lpips_fn(image[None], target[None])
    (cot,) = torch.autograd.grad(image_loss, image)
    out.image.backward(cot)
    jparams = {k: jnp.asarray(v) for k, v in start["params"].items() if k in port.params}
    _, vjp = jax.vjp(lambda fp: jt._render(
        fp, jt.alive, jt.cam_wvt[cam], jt.cam_fpt[cam], jt.cam_center[cam],
        jnp.zeros((cap, 2)), jnp.zeros(3)).image, jparams)
    (jgrads,) = vjp(jnp.asarray(cot.numpy()))
    for k in ("xyz", "f_dc", "scaling", "rotation", "opacity"):
        want = np.asarray(jgrads[k])
        got = port.params[k].grad.numpy()
        assert np.abs(got - want).max() <= RENDER_VJP_REL * np.abs(want).max(), k


def test_refine_with_lpips_matches_jax(weights, sphere):  # noqa: F811
    verts, faces, frames = sphere
    cfg = dict(REFINE_CFG, lambda_lpips=1.0)
    jr = JRefiner(JMesh(verts, faces), frames, JRefineConfig(**cfg),
                  lpips_fn=jl.load_lpips(weights["live"]))
    pr = TextureRefiner(Mesh(verts, faces), frames, RefineConfig(**cfg), device="cpu",
                        lpips_fn=pl.load_lpips(weights["live"], device="cpu"))
    jloss, loss = jr.run(5), pr.run(5)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    np.testing.assert_allclose(pr.logits.detach().numpy(), np.asarray(jr.logits),
                               rtol=0, atol=1e-5)


def test_ae_generator_step_with_lpips_matches_jax(weights):
    """One generator step (discriminator not yet on) with LPIPS in the
    reconstruction term: the logged losses rel 1e-4, every gradient
    element within 1e-4 of the module's largest (measured: ~3e-6; the
    tensors whose true gradient is 0, the biases ahead of a GroupNorm and
    the attention key biases, hold rounding, ~1e-9, on both sides)."""
    jt = _jax_trainer()
    jt.lpips_fn = jl.load_lpips(weights["live"])   # read when its step is traced
    grads = []
    opt = jt.opt

    def update(g, state, params=None):
        jax.debug.callback(lambda gg: grads.append(jax.tree_util.tree_map(np.asarray, gg)), g)
        return opt.update(g, state, params)

    jt.opt = optax.GradientTransformation(opt.init, update)
    kw = dict(AE_TINY, attn_resolutions=())
    pt = AutoencoderTrainer(PVAE.Encoder(double_z=True, **kw), PVAE.Decoder(out_ch=3, **kw),
                            AETrainConfig(lr=1e-4, disc_lr=1e-4, disc_start=2),
                            lpips_fn=pl.load_lpips(weights["live"], device="cpu"),
                            device="cpu")
    for name, sd in ae_trainer_state_from_jax(jt.params, jt.disc_params, pt).items():
        getattr(pt, name).load_state_dict(sd, strict=True)
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (2, 32, 32, 3)) * 2 - 1)
    _, r1, _ = jax.random.split(jt.rng, 3)
    noise = torch.from_numpy(np.array(jax.random.normal(r1, (2, 16, 16, 4))))
    ref = jt.train_step(jnp.asarray(x))
    got = pt.train_step(x, noise=noise)
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-4, abs=1e-7), (k, got, ref)
    jg = ae_trainer_state_from_jax(grads[0], jt.disc_params, pt)
    scale = {name: max(float(g.abs().max()) for g in jg[name].values())
             for name in ("encoder", "decoder")}
    for name in ("encoder", "decoder"):
        for k, p in getattr(pt, name).named_parameters():
            want = jg[name][k]
            assert float((p.grad - want).abs().max()) <= 1e-4 * scale[name], k
