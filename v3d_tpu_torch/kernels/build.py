"""Build and load the hand-written Hopper kernels.

``v3d_tpu_torch/csrc/*.cu`` are compiled with nvcc for ``sm_90a``, one nvcc
process per source, all started together, and linked into one shared library
with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o build/kernels/<name>.o csrc/<name>.cu  # each
    nvcc -shared -o build/kernels/libv3d_tpu_torch_kernels.so build/kernels/*.o

The library is built at first use and rebuilt when the hash of the sources
changes, headers included (``csrc/common.cuh``; ``csrc/hopper.cuh``, the
mbarrier / TMA / wgmma helpers of K1, K2, K7, K8 and K9).  A failed build raises.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
LIB_PATH = BUILD_DIR / "libv3d_tpu_torch_kernels.so"
STAMP_PATH = BUILD_DIR / "sources.sha256"
LOG_PATH = BUILD_DIR / "build.log"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# C signatures of the exported functions (see csrc/*.cu)
SIGNATURES = {
    "v3d_flash_attn_fwd": ([_I, _P, _P, _P, _P, _I, _I, _I, _I]
                           + [_L] * 12 + [_P, _P], _I),
    "v3d_flash_attn_fwd_wide": ([_I, _I, _P, _P, _P, _P, _I, _I, _I, _I]
                                + [_L] * 12 + [_P], _I),
    "v3d_flash_attn_fwd_smem": ([], _L),
    "v3d_flash_wgmma_probe": ([_I, _P, _P, _P, _P], _I),
    "v3d_flash_attn_fwd_wide_smem": ([_I, _I], _L),
    "v3d_flash_wide_probe": ([_I, _I, _P, _P, _P, _P], _I),
    "v3d_flash_attn_bwd_dq": ([_P] * 8 + [_I] * 4 + [_P, _P, _P], _I),
    "v3d_flash_attn_bwd_dkv": ([_P] * 7 + [_I] * 4 + [_P, _P, _P], _I),
    "v3d_flash_attn_bwd_smem": ([_I], _L),
    "v3d_flash_bwd_wgmma_probe": ([_I, _P, _P, _P, _P], _I),
    "v3d_group_norm": ([_I] + [_P] * 4 + [_I, _P] + [_I] * 4
                       + [ctypes.c_float] + [_I] * 5 + [_P, _P], _I),
    "v3d_group_norm_smem": ([_I] * 6, _L),
    "v3d_group_norm_stats": ([_I, _P, _P, _P] + [_I] * 5 + [_P], _I),
    "v3d_group_norm_apply": ([_I] + [_P] * 5 + [_I] * 5
                             + [ctypes.c_float] * 2 + [_I, _I, _P], _I),
    "v3d_layer_norm": ([_I, _I] + [_P] * 4 + [_L, _I, _L, ctypes.c_float] + [_I] * 4
                       + [_P], _I),
    "v3d_temporal_core": ([_I, _P, _P, _P, _P, _I, _I, _I, _I, _I]
                          + [_L] * 9 + [_P], _I),
    "v3d_temporal_core_smem": ([_I, _I], _L),
    "v3d_temporal_core_grid": ([_I, _I, _L], _L),
    "v3d_temporal_block": ([_I] + [_P] * 7 + [_I] * 6 + [_L] * 3 + [_P, _P], _I),
    "v3d_temporal_block_smem": ([_I, _I, _I, _I, _I], _L),
    "v3d_gs_composite_fwd": ([_P] * 4 + [_I] * 4 + [_P] * 8 + [_P], _I),
    "v3d_gs_composite_bwd": ([_P] * 3 + [_I] * 3 + [_P] * 8 + [_P], _I),
}


class KernelBuildError(RuntimeError):
    pass


def sources() -> list:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def sources_hash() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise KernelBuildError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")
    return nvcc


def build(force: bool = False) -> Path:
    """Compile csrc/*.cu into LIB_PATH unless an up-to-date build exists.
    Returns the library path; raises KernelBuildError on failure."""
    digest = sources_hash()
    if (not force and LIB_PATH.exists() and STAMP_PATH.exists()
            and STAMP_PATH.read_text().strip() == digest):
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in (p for p in sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c", "-o",
               str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, err = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n# rc {proc.returncode}\n{out}{err}")
        if proc.returncode != 0:
            failed.append(err)
    objs = [obj for _, obj, _ in jobs]
    tmp = LIB_PATH.with_suffix(f".{tag}.so")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp)] + [str(o) for o in objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(f"$ {' '.join(cmd)}\n# rc {proc.returncode}\n"
                   f"{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            failed.append(proc.stderr)
    LOG_PATH.write_text(f"# {time.perf_counter() - t0:.1f} s\n" + "\n".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError("nvcc failed:\n" + "\n".join(
            err[-4000:] for err in failed))
    os.replace(tmp, LIB_PATH)
    STAMP_PATH.write_text(digest + "\n")
    return LIB_PATH


_LIB: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _LIB = lib
    return _LIB
