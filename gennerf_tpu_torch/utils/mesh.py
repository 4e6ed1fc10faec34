"""A triangle mesh with binary little-endian PLY I/O (the port's copy of
gennerf_tpu/utils/mesh.py; its files are byte for byte those of the JAX
package's `Mesh.export`, with and without vertex colours).

The vertex and face records are written and read as numpy structured
arrays, one array each, so a mesh of a few hundred thousand faces takes
one copy, not a Python loop over the faces.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

_FACE = np.dtype([("n", "u1"), ("index", "<i4", (3,))])
_COLORED_VERTEX = np.dtype([("xyz", "<f4", (3,)), ("rgb", "u1", (3,))])


class Mesh:
    """Triangle mesh: vertices (V, 3) float64, faces (F, 3) int64, optional
    per-vertex colours (V, 3) and named per-vertex attributes."""

    def __init__(self, vertices: np.ndarray, faces: Optional[np.ndarray] = None,
                 vertex_colors: Optional[np.ndarray] = None,
                 vertex_attributes: Optional[Dict[str, np.ndarray]] = None):
        self.vertices = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
        self.faces = (np.zeros((0, 3), np.int64) if faces is None
                      else np.asarray(faces, dtype=np.int64).reshape(-1, 3))
        self.vertex_colors = (None if vertex_colors is None
                              else np.asarray(vertex_colors).reshape(-1, 3))
        self.vertex_attributes = dict(vertex_attributes or {})

    def __len__(self):
        return len(self.vertices)

    @property
    def is_empty(self) -> bool:
        return len(self.vertices) == 0

    def bounds(self) -> np.ndarray:
        """(2, 3): the min and max corner (zeros for an empty mesh)."""
        if self.is_empty:
            return np.zeros((2, 3))
        return np.stack([self.vertices.min(0), self.vertices.max(0)])

    def export(self, path: str) -> None:
        """Write a binary little-endian PLY (the only format)."""
        if not str(path).endswith(".ply"):
            raise ValueError(f"unsupported mesh format: {path}")
        has_color = self.vertex_colors is not None
        V, F = len(self.vertices), len(self.faces)
        header = ["ply", "format binary_little_endian 1.0", f"element vertex {V}"]
        header += [f"property float {a}" for a in "xyz"]
        if has_color:
            header += [f"property uchar {c}" for c in ("red", "green", "blue")]
        header += [f"element face {F}", "property list uchar int vertex_indices", "end_header"]
        if has_color:
            verts = np.empty(V, _COLORED_VERTEX)
            verts["xyz"] = self.vertices
            verts["rgb"] = np.clip(self.vertex_colors, 0, 255).astype(np.uint8)
        else:
            verts = self.vertices.astype("<f4")
        faces = np.empty(F, _FACE)
        faces["n"] = 3
        faces["index"] = self.faces
        with open(path, "wb") as f:
            f.write(("\n".join(header) + "\n").encode())
            f.write(verts.tobytes())
            f.write(faces.tobytes())

    @classmethod
    def load(cls, path: str) -> "Mesh":
        """Read a PLY in the layout `export` writes (with or without vertex
        colours)."""
        with open(path, "rb") as f:
            data = f.read()
        end = data.index(b"end_header\n") + len(b"end_header\n")
        V = F = 0
        has_color = False
        for line in data[:end].decode().splitlines():
            if line.startswith("element vertex"):
                V = int(line.split()[-1])
            elif line.startswith("element face"):
                F = int(line.split()[-1])
            elif line.startswith("property uchar red"):
                has_color = True
        vertex = _COLORED_VERTEX if has_color else np.dtype(("<f4", (3,)))
        records = np.frombuffer(data, vertex, V, end)
        faces = np.frombuffer(data, _FACE, F, end + V * vertex.itemsize)
        if not (faces["n"] == 3).all():
            raise ValueError(f"{path}: a face is not a triangle")
        if has_color:
            return cls(records["xyz"], faces["index"], records["rgb"].copy())
        return cls(records, faces["index"])
