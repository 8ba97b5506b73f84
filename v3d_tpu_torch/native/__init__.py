"""Host-side native code of the port, loaded with ctypes.

``marching_tets.cc`` (a copy of the JAX package's) is built with g++ into
``build/native/libmtets-<hash of the source>.so`` at first use; a failed
build raises with g++'s output.  ``imgdec.cc`` (the threaded PNG / JPEG
decoder, also a copy) is built the same way by ``native.imgdec``.  Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "marching_tets.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_lib = None


def lib_path(src: Optional[Path] = None, stem: str = "mtets") -> Path:
    src = src or SRC
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{stem}-{digest}.so"


def build(src: Optional[Path] = None, stem: str = "mtets", libs=()) -> Path:
    """Compile ``src`` (default: marching_tets.cc), linked with ``libs``,
    unless this source's build is there (written to a temporary name and
    renamed, so concurrent builds do not collide); raises with g++'s output
    when it fails."""
    src = src or SRC
    path = lib_path(src, stem)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(src), "-o", tmp, *libs]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        os.unlink(tmp)
        raise RuntimeError(f"{src.name}: g++ not found ({e})") from e
    if out.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{src.name}: {' '.join(cmd)} failed:\n"
                           f"{out.stdout}{out.stderr}")
    os.replace(tmp, path)
    return path


def load_mtets() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.mtets_run.restype = ctypes.c_int
        lib.mtets_run.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int64)]
        lib.mtets_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def marching_tets_native(sdf: np.ndarray, level: float = 0.0
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """C++ marching tetrahedra: (nx, ny, nz) float32 grid -> (vertices in
    index space (V, 3) float32, faces (F, 3) int32), welded on grid edges."""
    lib = load_mtets()
    sdf = np.ascontiguousarray(sdf, np.float32)
    nx, ny, nz = sdf.shape
    verts_p = ctypes.POINTER(ctypes.c_float)()
    faces_p = ctypes.POINTER(ctypes.c_int32)()
    nv, nf = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.mtets_run(sdf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                       nx, ny, nz, ctypes.c_float(level), ctypes.byref(verts_p),
                       ctypes.byref(nv), ctypes.byref(faces_p), ctypes.byref(nf))
    try:
        if rc != 0:
            raise MemoryError(f"mtets_run returned {rc}")
        if nv.value == 0:
            return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
        verts = np.ctypeslib.as_array(verts_p, shape=(nv.value, 3)).copy()
        faces = np.ctypeslib.as_array(faces_p, shape=(nf.value, 3)).copy()
    finally:
        lib.mtets_free(verts_p)
        lib.mtets_free(faces_p)
    return verts, faces
