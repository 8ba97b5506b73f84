"""ctypes wrapper of the native image decoder (``imgdec.cc``, a copy of the
JAX package's): libpng / libjpeg decodes with a std::thread batch fan-out,
the host-side stand-in for the decode parallelism of the reference's torch
DataLoader workers.  A port of v3d_tpu/native/imgdec.py with its API and its
contract: where g++, libpng or libjpeg is missing, the build fails once,
that failure is printed, and every entry point returns None, so the callers
decode with PIL instead.

The library is built with g++ into ``build/native/libimgdec-<hash of the
source>.so`` at first use.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from v3d_tpu_torch import native

SRC = Path(__file__).resolve().parent / "imgdec.cc"
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int)


def load_imgdec() -> Optional[ctypes.CDLL]:
    """The library, built at first use; None (the failure printed once) where
    it cannot be built or loaded."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        lib = ctypes.CDLL(str(native.build(SRC, "imgdec",
                                           ("-lpng16", "-ljpeg", "-pthread"))))
    except (RuntimeError, OSError) as e:
        print(f"native imgdec unavailable ({e}); using PIL fallback", flush=True)
        _lib_failed = True
        return None
    lib.imgdec_probe.restype = ctypes.c_int
    lib.imgdec_probe.argtypes = [_u8p, ctypes.c_int64, _i32p, _i32p]
    lib.imgdec_decode.restype = ctypes.c_int
    lib.imgdec_decode.argtypes = [_u8p, ctypes.c_int64, _u8p,
                                  ctypes.c_int64, _i32p, _i32p]
    lib.imgdec_decode_batch.restype = ctypes.c_int
    lib.imgdec_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, _u8p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _i32p]
    _lib = lib
    return lib


def decode_image(src: Union[str, bytes]) -> Optional[np.ndarray]:
    """Decode one PNG / JPEG (path or bytes) -> (h, w, 4) uint8 RGBA, or None
    when the library is unavailable or the data does not decode."""
    lib = load_imgdec()
    if lib is None:
        return None
    if isinstance(src, str):
        try:
            with open(src, "rb") as f:
                src = f.read()
        except OSError:
            return None
    buf = np.frombuffer(src, np.uint8)
    data = buf.ctypes.data_as(_u8p)
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.imgdec_probe(data, buf.size, ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    out = np.empty((h.value, w.value, 4), np.uint8)
    rc = lib.imgdec_decode(data, buf.size, out.ctypes.data_as(_u8p),
                           out.nbytes, ctypes.byref(w), ctypes.byref(h))
    return out if rc == 0 else None


def decode_batch(paths: Sequence[str], size: Tuple[int, int],
                 threads: int = 0) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Threaded decode of same-size files -> ((n, h, w, 4) uint8, ok (n,)
    bool).  ``size`` is (h, w); items that fail or mismatch have ok False
    (their pixels are undefined).  threads = 0: one per CPU."""
    lib = load_imgdec()
    if lib is None:
        return None
    h, w = size
    n = len(paths)
    out = np.empty((n, h, w, 4), np.uint8)
    rcs = np.zeros(n, np.int32)
    if threads <= 0:
        threads = len(os.sched_getaffinity(0))
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.imgdec_decode_batch(arr, n, out.ctypes.data_as(_u8p), w, h,
                            threads, rcs.ctypes.data_as(_i32p))
    return out, rcs == 0


def load_rgba(path: str) -> np.ndarray:
    """RGBA uint8 through the native decoder, PIL otherwise."""
    out = decode_image(path)
    if out is not None:
        return out
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGBA"))
