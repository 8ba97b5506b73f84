"""Mesh container and IO (counterpart of v3d_tpu/meshops/mesh.py, the
replacement for the vendored kiui Mesh, mesh_recon/mesh.py:10-845, and the
trimesh export of refine.py:248-256).

OBJ (+ vertex colours), PLY and minimal GLB 2.0 with struct and json only;
``auto_normal`` matches mesh.py:460-483 (area-weighted vertex normals) and
``auto_uv`` mesh.py:485-523 with ``meshops.uv.atlas_unwrap`` in place of
xatlas.  The files are byte for byte those of the JAX package's ``Mesh``."""

from __future__ import annotations

import dataclasses
import json
import struct
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray                 # (V, 3) float32
    faces: np.ndarray                    # (F, 3) int32
    vertex_colors: Optional[np.ndarray] = None   # (V, 3) float in [0,1]
    vertex_normals: Optional[np.ndarray] = None  # (V, 3)
    uvs: Optional[np.ndarray] = None             # (V, 2) after auto_uv(vmap)

    def auto_uv(self, cache_path: Optional[str] = None,
                vmap: bool = True) -> "Mesh":
        """UV atlas unwrap (kiui Mesh.auto_uv semantics).  With ``vmap`` the
        vertex arrays are remapped so every vertex has a unique uv
        (chart-boundary vertices get duplicated), as GLTF-style export
        needs; ``cache_path`` keeps the atlas in ``<path>_uv.npz``."""
        import os

        from v3d_tpu_torch.meshops.uv import atlas_unwrap

        if cache_path is not None:
            cache_path = os.path.splitext(cache_path)[0] + "_uv.npz"
        if cache_path is not None and os.path.exists(cache_path):
            data = np.load(cache_path)
            vt, ft, vmapping = data["vt"], data["ft"], data["vmapping"]
        else:
            vmapping, ft, vt = atlas_unwrap(self.vertices, self.faces)
            if cache_path is not None:
                np.savez(cache_path, vt=vt, ft=ft, vmapping=vmapping)
        if vmap:
            self.vertices = self.vertices[vmapping]
            if self.vertex_colors is not None:
                self.vertex_colors = self.vertex_colors[vmapping]
            if self.vertex_normals is not None:
                self.vertex_normals = self.vertex_normals[vmapping]
            self.faces = ft.astype(np.int32)
            self.uvs = vt.astype(np.float32)
        else:
            self.uvs = vt.astype(np.float32)
            self._ft = ft
        return self

    def auto_normal(self) -> "Mesh":
        v, f = self.vertices, self.faces
        fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        vn = np.zeros_like(v)
        np.add.at(vn, f[:, 0], fn)
        np.add.at(vn, f[:, 1], fn)
        np.add.at(vn, f[:, 2], fn)
        norm = np.linalg.norm(vn, axis=1, keepdims=True)
        self.vertex_normals = (vn / np.maximum(norm, 1e-12)).astype(np.float32)
        return self

    # ------------------------------------------------------------ OBJ ----
    def write_obj(self, path: str) -> None:
        with open(path, "w") as fo:
            for i, v in enumerate(self.vertices):
                if self.vertex_colors is not None:
                    c = self.vertex_colors[i]
                    fo.write(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
                else:
                    fo.write(f"v {v[0]} {v[1]} {v[2]}\n")
            if self.vertex_normals is not None:
                for n in self.vertex_normals:
                    fo.write(f"vn {n[0]} {n[1]} {n[2]}\n")
            if self.uvs is not None:
                for t in self.uvs:
                    fo.write(f"vt {t[0]} {t[1]}\n")
                for f in self.faces + 1:
                    fo.write(f"f {f[0]}/{f[0]} {f[1]}/{f[1]} "
                             f"{f[2]}/{f[2]}\n")
                return
            for f in self.faces + 1:
                fo.write(f"f {f[0]} {f[1]} {f[2]}\n")

    @staticmethod
    def read_obj(path: str) -> "Mesh":
        verts, colors, faces = [], [], []
        with open(path) as fi:
            for line in fi:
                parts = line.split()
                if not parts:
                    continue
                if parts[0] == "v":
                    verts.append([float(x) for x in parts[1:4]])
                    if len(parts) >= 7:
                        colors.append([float(x) for x in parts[4:7]])
                elif parts[0] == "f":
                    idx = [int(p.split("/")[0]) - 1 for p in parts[1:4]]
                    faces.append(idx)
        return Mesh(np.asarray(verts, np.float32), np.asarray(faces, np.int32),
                    np.asarray(colors, np.float32) if colors else None)

    # ------------------------------------------------------------ PLY ----
    def write_ply(self, path: str) -> None:
        v = self.vertices.astype(np.float32)
        n = v.shape[0]
        has_c = self.vertex_colors is not None
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {n}",
                  "property float x", "property float y", "property float z"]
        if has_c:
            header += ["property uchar red", "property uchar green",
                       "property uchar blue"]
        header += [f"element face {self.faces.shape[0]}",
                   "property list uchar int vertex_indices", "end_header", ""]
        with open(path, "wb") as fo:
            fo.write("\n".join(header).encode())
            if has_c:
                c = np.clip(self.vertex_colors * 255, 0, 255).astype(np.uint8)
                rec = np.zeros(n, dtype=[("xyz", np.float32, 3),
                                         ("rgb", np.uint8, 3)])
                rec["xyz"] = v
                rec["rgb"] = c
                fo.write(rec.tobytes())
            else:
                fo.write(v.tobytes())
            frec = np.zeros(self.faces.shape[0],
                            dtype=[("n", np.uint8), ("idx", np.int32, 3)])
            frec["n"] = 3
            frec["idx"] = self.faces
            fo.write(frec.tobytes())

    # ------------------------------------------------------------ GLB ----
    def write_glb(self, path: str) -> None:
        """Minimal GLB 2.0 with POSITION (+COLOR_0) and indices."""
        v = self.vertices.astype(np.float32)
        f = self.faces.astype(np.uint32).reshape(-1)
        buffers = [v.tobytes(), f.tobytes()]
        accessors = [
            {"bufferView": 0, "componentType": 5126, "count": len(v),
             "type": "VEC3", "min": v.min(0).tolist(), "max": v.max(0).tolist()},
            {"bufferView": 1, "componentType": 5125, "count": len(f),
             "type": "SCALAR"},
        ]
        attributes = {"POSITION": 0}
        if self.vertex_colors is not None:
            c = self.vertex_colors.astype(np.float32)
            buffers.append(c.tobytes())
            accessors.append({"bufferView": 2, "componentType": 5126,
                              "count": len(c), "type": "VEC3"})
            attributes["COLOR_0"] = 2
        views = []
        offset = 0
        for b in buffers:
            views.append({"buffer": 0, "byteOffset": offset, "byteLength": len(b)})
            offset += len(b) + (-len(b)) % 4
        bin_data = b"".join(b + b"\x00" * ((-len(b)) % 4) for b in buffers)
        gltf = {
            "asset": {"version": "2.0", "generator": "v3d_tpu"},
            "scene": 0, "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
            "meshes": [{"primitives": [{"attributes": attributes,
                                        "indices": 1, "mode": 4}]}],
            "accessors": accessors, "bufferViews": views,
            "buffers": [{"byteLength": len(bin_data)}],
        }
        js = json.dumps(gltf).encode()
        js += b" " * ((-len(js)) % 4)
        total = 12 + 8 + len(js) + 8 + len(bin_data)
        with open(path, "wb") as fo:
            fo.write(struct.pack("<III", 0x46546C67, 2, total))
            fo.write(struct.pack("<II", len(js), 0x4E4F534A))
            fo.write(js)
            fo.write(struct.pack("<II", len(bin_data), 0x004E4942))
            fo.write(bin_data)
