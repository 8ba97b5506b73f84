"""The port's native image decoder (v3d_tpu_torch/native/imgdec.cc, a copy
of the JAX package's, built by g++ into build/native/) against the JAX
package's decoder and PIL: PNG RGBA / RGB / gray and bytes exact, JPEG
exact against the JAX decoder (the same libjpeg) and within 2 of PIL,
batches with their failures masked, garbage refused; without the library
every entry point returns None and the readers decode with PIL.
"""

import numpy as np
import pytest
from PIL import Image

from v3d_tpu.native import imgdec as jimgdec
from v3d_tpu_torch.data.objaverse import _decode_orbit
from v3d_tpu_torch.native import imgdec


def _save(tmp_path, name, arr, mode, **kw):
    p = str(tmp_path / name)
    Image.fromarray(arr, mode).save(p, **kw)
    return p


def _cases(tmp_path):
    rs = np.random.RandomState(0)
    smooth = np.kron(rs.randint(0, 200, (4, 5, 3)), np.ones((8, 8, 1))).astype(np.uint8)
    return {
        "rgba": _save(tmp_path, "a.png", rs.randint(0, 256, (21, 17, 4), dtype=np.uint8), "RGBA"),
        "rgb": _save(tmp_path, "b.png", rs.randint(0, 256, (9, 11, 3), dtype=np.uint8), "RGB"),
        "gray": _save(tmp_path, "c.png", rs.randint(0, 256, (8, 6), dtype=np.uint8), "L"),
        "jpeg": _save(tmp_path, "d.jpg", smooth, "RGB", quality=95),
    }


@pytest.mark.parametrize("kind", ["rgba", "rgb", "gray", "jpeg"])
def test_decode_image_matches_jax_and_pil(tmp_path, kind):
    path = _cases(tmp_path)[kind]
    out = imgdec.decode_image(path)
    assert out is not None and out.dtype == np.uint8 and out.shape[-1] == 4
    np.testing.assert_array_equal(out, jimgdec.decode_image(path))
    pil = np.asarray(Image.open(path).convert("RGBA"))
    if kind == "jpeg":
        np.testing.assert_allclose(out.astype(int), pil.astype(int), atol=2)
    else:
        np.testing.assert_array_equal(out, pil)
    with open(path, "rb") as f:
        np.testing.assert_array_equal(imgdec.decode_image(f.read()), out)
    np.testing.assert_array_equal(imgdec.load_rgba(path), jimgdec.load_rgba(path))


def test_garbage_and_missing_files(tmp_path):
    assert imgdec.decode_image(b"not an image at all") is None
    assert imgdec.decode_image(str(tmp_path / "missing.png")) is None
    assert jimgdec.decode_image(b"not an image at all") is None


def test_decode_batch_matches_jax(tmp_path):
    rs = np.random.RandomState(4)
    paths = [_save(tmp_path, f"f{i}.png", rs.randint(0, 256, (12, 10, 4), dtype=np.uint8),
                   "RGBA") for i in range(8)]
    out, ok = imgdec.decode_batch(paths, (12, 10), threads=4)
    jout, jok = jimgdec.decode_batch(paths, (12, 10), threads=4)
    assert ok.all() and jok.all()
    np.testing.assert_array_equal(out, jout)
    bad = _save(tmp_path, "wrong.png", np.zeros((3, 3, 4), np.uint8), "RGBA")
    out, ok = imgdec.decode_batch([paths[0], bad, str(tmp_path / "nope.png")], (12, 10),
                                  threads=0)
    assert ok.tolist() == [True, False, False]
    np.testing.assert_array_equal(out[0], jout[0])


def test_orbit_decode_takes_native_path_like_jax(tmp_path, monkeypatch):
    from v3d_tpu.data.objaverse import _decode_orbit as jdecode

    rs = np.random.RandomState(6)
    paths = [_save(tmp_path, f"o{i}.png", rs.randint(0, 256, (16, 16, 4), dtype=np.uint8),
                   "RGBA") for i in range(3)]
    calls = []
    batch = imgdec.decode_batch
    monkeypatch.setattr(imgdec, "decode_batch",
                        lambda *a, **k: calls.append(a) or batch(*a, **k))
    out = _decode_orbit(paths)
    assert len(calls) == 1
    np.testing.assert_array_equal(out, jdecode(paths))
    # frames of unequal size: the batch flags one, PIL decodes, stack fails
    odd = _save(tmp_path, "odd.png", np.zeros((8, 8, 4), np.uint8), "RGBA")
    with pytest.raises(ValueError):
        _decode_orbit(paths + [odd])


def test_without_the_library_everything_falls_back_to_pil(tmp_path, monkeypatch, capsys):
    path = _cases(tmp_path)["rgba"]
    monkeypatch.setattr(imgdec, "_lib", None)
    monkeypatch.setattr(imgdec, "_lib_failed", False)
    monkeypatch.setattr(imgdec, "SRC", tmp_path / "bad.cc")
    (tmp_path / "bad.cc").write_text("this is not C++\n")
    assert imgdec.load_imgdec() is None
    assert "native imgdec unavailable" in capsys.readouterr().out
    assert imgdec.load_imgdec() is None
    assert capsys.readouterr().out == ""          # printed once
    assert imgdec.decode_image(path) is None
    assert imgdec.decode_batch([path], (21, 17)) is None
    np.testing.assert_array_equal(imgdec.load_rgba(path),
                                  np.asarray(Image.open(path).convert("RGBA")))
    np.testing.assert_array_equal(
        _decode_orbit([path]), np.asarray(Image.open(path).convert("RGB"), np.float32)[None])
