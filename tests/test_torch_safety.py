"""The port's safety filter and watermark (v3d_tpu_torch/utils/safety.py)
against the JAX package's, on the CPU.

- ``_blur`` against ``cv2.GaussianBlur(im, (31, 31), 0)`` itself (skipped
  where cv2 is absent): max abs 1e-5 on [0, 1] images (float64 taps and
  sums here, OpenCV's float32 ones);
- ``embed_watermark`` / ``extract_watermark``: equal to the JAX package's
  (the same float64 numpy), and the 48 bits read back after a uint8 save;
- ``_run_head`` (the linear probe and the MLP form): equal;
- the filter with a narrow ViT (width 64, 2 layers, ViT-L's patch 14) from
  one seeded ``state_dict()`` and seeded heads in ``$V3D_TPU_SAFETY_HEADS``'s
  layout: the same frames flagged (heads' biases set half-way between the
  middle logits, so no flag sits within float32 rounding of its threshold),
  features within 1e-5, the filtered frames within 1e-5 (the JAX side blurs
  with cv2, the port with its own taps).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import MAP_CLIP, numpy_init_, to_flax
from v3d_tpu.models.clip_vit import CLIPVisionTransformer as JCLIP
from v3d_tpu.utils import safety as jsafe
from v3d_tpu_torch.models.clip_vit import CLIPVisionTransformer
from v3d_tpu_torch.utils import safety as psafe

torch.set_num_threads(1)
NARROW_VIT = dict(width=64, layers=2, heads=4, patch_size=14, image_size=224,
                  output_dim=32)


@pytest.mark.parametrize("shape", [(40, 48, 3), (512, 512, 3), (12, 20, 3)])
def test_blur_matches_cv2(shape):
    cv2 = pytest.importorskip("cv2")
    im = np.random.RandomState(0).rand(2, *shape).astype(np.float32)
    want = np.stack([cv2.GaussianBlur(i, (31, 31), 0) for i in im])
    got = psafe._blur(im)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5
    assert psafe.VIT_L_CONFIG == jsafe.VIT_L_CONFIG


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_watermark_equal_to_jax(dtype):
    imgs = np.random.RandomState(1).rand(2, 128, 96, 3).astype(dtype)
    want = jsafe.embed_watermark(imgs)
    got = psafe.embed_watermark(imgs)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    wm8 = np.round(got * 255).astype(np.uint8).astype(np.float32) / 255.0
    bits = psafe.extract_watermark(wm8)
    np.testing.assert_array_equal(bits, jsafe.extract_watermark(wm8))
    assert np.array_equal(bits.astype(int), np.array(psafe.WATERMARK_BITS))
    assert psafe.WATERMARK_BITS == jsafe.WATERMARK_BITS
    np.testing.assert_array_equal(psafe.extract_watermark(imgs),
                                  jsafe.extract_watermark(imgs))
    other = [1 - b for b in psafe.WATERMARK_BITS]
    np.testing.assert_array_equal(psafe.embed_watermark(imgs, bits=other),
                                  jsafe.embed_watermark(imgs, bits=other))


def test_run_head_equal():
    rs = np.random.RandomState(2)
    feats = rs.randn(5, 32).astype(np.float32)
    linear = {"weights": rs.randn(32).astype(np.float32), "biases": np.float32(0.3)}
    mlp = {"w0": rs.randn(32, 16).astype(np.float32), "b0": rs.randn(16).astype(np.float32),
           "w1": rs.randn(16, 1).astype(np.float32), "b1": rs.randn(1).astype(np.float32)}
    for head in (linear, mlp):
        np.testing.assert_array_equal(psafe._run_head(head, feats),
                                      jsafe._run_head(head, feats))


def test_filter_matches_jax(tmp_path, monkeypatch):
    pytest.importorskip("cv2")
    clip = numpy_init_(CLIPVisionTransformer(**NARROW_VIT), 3)
    params = to_flax(clip, MAP_CLIP)
    jclip = JCLIP(**NARROW_VIT)
    imgs = np.random.RandomState(4).rand(6, 40, 48, 3).astype(np.float32)
    imgs[:, :20] *= np.linspace(0.2, 1.0, 6)[:, None, None, None]
    rs = np.random.RandomState(5)
    w_p, w_w = rs.randn(32).astype(np.float32), rs.randn(32).astype(np.float32)

    pfilt0 = psafe.DeepFloydDataFiltering(clip=clip, head_dir=str(tmp_path))
    assert pfilt0.p_head is None and pfilt0(imgs) is imgs  # no heads: pass-through
    feats = pfilt0.features(imgs)

    def bias(w, k):  # half-way between the k-th and (k+1)-th smallest logits
        z = np.sort(feats @ w)
        return np.float32(-(z[k - 1] + z[k]) / 2)

    np.savez(tmp_path / "p_head_v1.npz", weights=w_p, biases=bias(w_p, 4))
    np.savez(tmp_path / "w_head_v1.npz", weights=w_w, biases=bias(w_w, 5))
    monkeypatch.setenv("V3D_TPU_SAFETY_HEADS", str(tmp_path))
    jfilt = jsafe.DeepFloydDataFiltering(clip_apply=jax.jit(jclip.apply),
                                         clip_params=params)
    pfilt = psafe.DeepFloydDataFiltering(clip=clip)

    from v3d_tpu.models.clip_vit import clip_preprocess as jprep
    jfeats = np.asarray(jclip.apply(params, jprep(jnp.asarray(imgs) * 2 - 1)))
    jfeats = jfeats / np.linalg.norm(jfeats, axis=-1, keepdims=True)
    assert np.abs(pfilt.features(imgs) - jfeats).max() <= 1e-5
    flags = pfilt.flags(imgs)
    assert 0 < flags.sum() < len(imgs)
    want, got = jfilt(imgs), pfilt(imgs)
    changed = np.abs(want - imgs).max(axis=(1, 2, 3)) > 0
    np.testing.assert_array_equal(changed, flags)
    assert np.abs(got - want).max() <= 1e-5
    np.testing.assert_array_equal(got[~flags], imgs[~flags])
