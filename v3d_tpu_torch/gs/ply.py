"""PLY IO for gaussian point clouds, byte-compatible with the reference
(recon/scene/gaussian_model.py:236-359 save_ply/load_ply); a numpy copy of
v3d_tpu/gs/ply.py ``save_ply`` / ``load_ply``."""

from __future__ import annotations

from typing import Dict

import numpy as np


def _property_names(f_rest_dim: int) -> list:
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(f_rest_dim)]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]
    return names


def save_ply(path: str, g_np: Dict[str, np.ndarray]) -> None:
    """The alive gaussians of ``g_np`` (``GSTrainer.gaussians_np()``)."""
    alive = g_np["alive"].astype(bool)
    xyz = g_np["xyz"][alive]
    n = xyz.shape[0]
    # the reference stores features transposed flat: (N, 3, M) contiguous
    f_dc = g_np["f_dc"][alive].transpose(0, 2, 1).reshape(n, -1)
    f_rest = g_np["f_rest"][alive].transpose(0, 2, 1).reshape(n, -1)
    attrs = np.concatenate([
        xyz, np.zeros_like(xyz), f_dc, f_rest, g_np["opacity"][alive],
        g_np["scaling"][alive], g_np["rotation"][alive]], axis=1).astype(np.float32)
    names = _property_names(f_rest.shape[1])
    assert attrs.shape[1] == len(names)
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        header += [f"property float {nm}" for nm in names]
        header += ["end_header", ""]
        f.write("\n".join(header).encode())
        f.write(attrs.tobytes())


def load_ply(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        n, names = 0, []
        for line in header.decode().splitlines():
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property float"):
                names.append(line.split()[-1])
        data = np.frombuffer(f.read(n * len(names) * 4), np.float32)
    data = data.reshape(n, len(names))
    col = {nm: i for i, nm in enumerate(names)}
    rest = sorted((nm for nm in names if nm.startswith("f_rest_")),
                  key=lambda s: int(s.split("_")[-1]))
    if rest:
        f_rest = data[:, [col[nm] for nm in rest]].reshape(n, 3, -1).transpose(0, 2, 1)
    else:
        f_rest = np.zeros((n, 0, 3), np.float32)
    return {
        "xyz": data[:, [col["x"], col["y"], col["z"]]].copy(),
        "f_dc": data[:, [col[f"f_dc_{i}"] for i in range(3)]][:, None, :].copy(),
        "f_rest": f_rest.copy(),
        "opacity": data[:, [col["opacity"]]].copy(),
        "scaling": data[:, [col[f"scale_{i}"] for i in range(3)]].copy(),
        "rotation": data[:, [col[f"rot_{i}"] for i in range(4)]].copy(),
        "alive": np.ones(n, bool),
    }
