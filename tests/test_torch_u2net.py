"""The port's U2Net (v3d_tpu_torch/models/u2net.py) and the U2Net matte in
``preprocess_image`` against the JAX package, on the CPU in float32.

One seeded ``state_dict()`` in U-2-Net's naming (random BatchNorm
statistics, so the eval-mode affine is exercised) drives both packages, the
JAX side through its ``convert_u2net``.

Tolerances:
- the seven sigmoid maps of the full U2Net and of u2netp at 64^2 and at
  37 x 45 (odd sizes: ceil-mode pooling, resizes to odd sizes): max abs
  1e-4 (float32 convolutions through six levels of a UNet of UNets);
- ``u2net_matte``'s alpha: within 1 of 255 (the uint8 cast truncates);
- the repair: with u2netp weights on disk (``$V3D_U2NET_CKPT``) both
  packages' ``preprocess_image`` take the U2Net matte: within C5's 0.01 on
  the [-1, 1] output (test_torch_diffusion.py), and away from the
  luminance matte's output, which the port gave before.
"""

import os

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from v3d_tpu.core.convert import convert_u2net
from v3d_tpu.data import preprocess as jpre
from v3d_tpu.models.u2net import U2Net as JU2Net
from v3d_tpu.models.u2net import u2net_matte as j_matte
from v3d_tpu_torch.data import preprocess as ppre
from v3d_tpu_torch.models.u2net import U2Net, load_u2net, u2net_matte

torch.set_num_threads(1)


@torch.no_grad()
def seeded_u2net(small: bool, seed: int) -> U2Net:
    """torch's default init from ``seed``, BatchNorm affines and running
    statistics drawn from the same seed."""
    torch.manual_seed(seed)
    model = U2Net(small=small)
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            n = m.num_features
            m.weight.copy_(1 + 0.1 * torch.randn(n, generator=gen))
            m.bias.copy_(0.1 * torch.randn(n, generator=gen))
            m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
            m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
    return model.eval()


def _image(h, w, seed=0):
    """An RGB object (a noisy ellipse) on a grey background, uint8."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w] / max(h, w)
    inside = (yy - 0.5) ** 2 / 0.08 + (xx - 0.45) ** 2 / 0.05 < 1
    img = np.where(inside[..., None], rs.randint(30, 200, (h, w, 3)), 235)
    return img.astype(np.uint8)


@pytest.mark.parametrize("hw", [(64, 64), (37, 45)])
@pytest.mark.parametrize("small", [True, False])
def test_u2net_matches_jax(small, hw):
    port = seeded_u2net(small, 1)
    params = convert_u2net(port.state_dict())
    x = np.random.RandomState(2).rand(1, *hw, 3).astype(np.float32)
    want = jax.jit(JU2Net(small=small).apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 7
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape == (1, *hw, 1)
        assert np.abs(g - np.asarray(w)).max() <= 1e-4, i
    assert float(got[0].std()) > 1e-3  # the random weights give a non-flat map
    if not small:
        assert sum(p.numel() for p in port.parameters()) == 44_009_869


def test_u2net_matte_matches_jax():
    port = seeded_u2net(True, 3)
    params = convert_u2net(port.state_dict())
    img = _image(50, 60)
    want = j_matte(jax.jit(JU2Net(small=True).apply), params, img)
    got = u2net_matte(port, img)
    assert got.shape == want.shape == (50, 60, 4) and got.dtype == np.uint8
    np.testing.assert_array_equal(got[..., :3], img)
    assert np.abs(got[..., 3].astype(int) - want[..., 3].astype(int)).max() <= 1
    assert int(got[..., 3].max()) - int(got[..., 3].min()) > 100


IMG = _image(24, 20, seed=2)


def _weights(seed, path, wrap=False):
    """Seeded u2netp weights saved at ``path``; returns their matte of IMG."""
    model = seeded_u2net(True, seed)
    sd = model.state_dict()
    torch.save({"state_dict": sd} if wrap else sd, path)
    return u2net_matte(model, IMG)


def _same(fn, want):
    return fn is not None and fn.kind == "u2net" and np.array_equal(fn(IMG), want)


def test_load_u2net_search_order(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("V3D_U2NET_CKPT", raising=False)
    assert load_u2net(device="cpu") is None
    os.makedirs("ckpts")
    m_p = _weights(4, "ckpts/u2netp.pth")
    assert _same(load_u2net(device="cpu"), m_p)  # u2netp detected from its channels
    # ckpts/u2net.pth comes before ckpts/u2netp.pth (here: u2netp weights,
    # wrapped as a Lightning-style {"state_dict": ...})
    m_u = _weights(5, "ckpts/u2net.pth", wrap=True)
    assert not np.array_equal(m_u, m_p)
    assert _same(load_u2net(device="cpu"), m_u)
    # then the environment variable, then the argument
    m_env = _weights(6, str(tmp_path / "env.pth"))
    monkeypatch.setenv("V3D_U2NET_CKPT", str(tmp_path / "env.pth"))
    assert _same(load_u2net(device="cpu"), m_env)
    m_arg = _weights(7, str(tmp_path / "arg.pth"))
    assert _same(load_u2net(str(tmp_path / "arg.pth"), device="cpu"), m_arg)
    # an orbax tree (a directory) ahead of the .pth files is refused
    monkeypatch.delenv("V3D_U2NET_CKPT")
    os.makedirs("ckpts/u2net.orbax")
    with pytest.raises(ValueError, match="orbax"):
        load_u2net(device="cpu")


def test_preprocess_takes_u2net_matte_like_jax(tmp_path, monkeypatch):
    """The repair: the JAX ``preprocess_image`` mattes with U2Net where its
    weights are on disk (preprocess.py:71-86, :100); so does the port."""
    pytest.importorskip("cv2")
    _weights(8, str(tmp_path / "u2netp.pth"))
    monkeypatch.setenv("V3D_U2NET_CKPT", str(tmp_path / "u2netp.pth"))
    monkeypatch.setattr(jpre, "_DEFAULT_MATTE", [])
    monkeypatch.setattr(ppre, "_DEFAULT_MATTE", {})
    img = _image(90, 70, seed=1)
    want = jpre.preprocess_image(img, resolution=64)
    got = ppre.preprocess_image(img, resolution=64, device="cpu")
    assert ppre.default_remove_bg("cpu").kind == "u2net"
    assert got.shape == want.shape == (64, 64, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=0.01)
    luminance = ppre.preprocess_image(img, resolution=64, device="cpu",
                                      remove_bg=ppre.luminance_matte)
    assert np.abs(luminance - want).max() > 0.1
