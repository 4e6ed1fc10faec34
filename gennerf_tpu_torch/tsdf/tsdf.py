"""The TSDF volume: npz save/load in the reference layout and the rigid
resample that 3D augmentation applies to the ground truth (counterpart of
gennerf_tpu/tsdf/tsdf.py).

`transform` is host pipeline work: the loaders call it in their worker
threads, as the reference's DataLoader workers do. It runs in float32
numpy, one core a call, so the loader threads share the host's cores
instead of each starting torch's intra-op pool on all of them. `get_mesh`
runs marching cubes in the port's host C++ library (utils/native.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..data.colormaps import NYU40_COLORMAP
from ..utils.mesh import Mesh
from ..utils.native import marching_cubes


def _transform_sample_grid(transform: np.ndarray, origin: np.ndarray, old_origin: np.ndarray,
                           voxel_dim, old_dim, voxel_size: float):
    """(3, V) float32 coordinates of the new grid's voxels in the old
    volume's index space, as grid_sample with align_corners=False reads
    them, and the (V,) out-of-bounds mask.

    The normalization is the align_corners=True formula 2*i/(n-1) - 1
    while the sampling unnormalizes with align_corners=False: the
    reference's deliberate half-voxel quirk, kept."""
    world = np.indices(voxel_dim, dtype=np.float32).reshape(3, -1) * np.float32(voxel_size)
    world = world + origin.reshape(3, 1)
    world = np.concatenate([world, np.ones_like(world[:1])], axis=0)
    # einsum's own loop: BLAS would start its thread pool in every loader thread
    world = np.einsum("ij,jk->ik", transform[:3], world)
    grid = (world - old_origin.reshape(3, 1)) / np.float32(voxel_size)
    dims = np.asarray(old_dim, np.float32).reshape(3, 1)
    norm = 2.0 * grid / (dims - 1.0) - 1.0
    oob = (np.abs(norm) >= 1).any(axis=0)
    return ((norm + 1.0) * dims - 1.0) * 0.5, oob


def _resample(vol: np.ndarray, coords: np.ndarray, mode: str) -> np.ndarray:
    """(C, n0, n1, n2) float32 volume at (3, V) index coordinates -> (C, V):
    grid_sample's 'nearest' (half to even) or 'bilinear' with
    padding_mode='zeros' (a tap outside the volume reads 0), the lerps in
    its order (last axis first)."""
    C = vol.shape[0]
    # a border of zeros: a tap index clipped into [-1, n] reads 0 outside
    padded = np.pad(vol, ((0, 0), (1, 1), (1, 1), (1, 1))).reshape(C, -1)
    dims = vol.shape[1:]
    strides = ((dims[1] + 2) * (dims[2] + 2), dims[2] + 2, 1)

    def offsets(index, axis):
        """Flat offsets of the padded volume along one axis."""
        return (np.clip(index, -1, dims[axis]) + 1) * strides[axis]

    if mode == "nearest":
        i0, i1, i2 = np.rint(coords).astype(np.int64)
        return np.take(padded, offsets(i0, 0) + offsets(i1, 1) + offsets(i2, 2), axis=1)
    base = np.floor(coords)
    w0, w1, w2 = coords - base
    a = base.astype(np.int64)
    o0, o1, o2 = ((offsets(a[k], k), offsets(a[k] + 1, k)) for k in range(3))

    def lerp2(j0, j1):
        """The pair of taps along the last axis, lerped."""
        row = o0[j0] + o1[j1]
        lo, hi = (np.take(padded, row + o, axis=1) for o in o2)
        return lo * (1 - w2) + hi * w2

    c0 = lerp2(0, 0) * (1 - w1) + lerp2(0, 1) * w1
    c1 = lerp2(1, 0) * (1 - w1) + lerp2(1, 1) * w1
    return c0 * (1 - w0) + c1 * w0


@dataclasses.dataclass
class TSDF:
    """A truncated signed distance volume and how to place it.

    voxel_size: metric voxel size; origin: (1, 3) world position of voxel
    (0, 0, 0); tsdf_vol: (nx, ny, nz) values in [-1, 1]; attribute_vols:
    extra per-voxel volumes ('color' (3, nx, ny, nz), 'instance', ...);
    attributes: non-volume extras."""

    voxel_size: float
    origin: torch.Tensor
    tsdf_vol: torch.Tensor
    attribute_vols: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    attributes: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def save(self, fname: str) -> None:
        """np.savez_compressed with keys origin, voxel_size, tsdf and one per
        attribute volume or attribute: the reference's layout."""
        def host(x):
            a = x.detach().cpu() if isinstance(x, torch.Tensor) else x
            if isinstance(a, torch.Tensor):
                a = (a.float() if a.dtype == torch.bfloat16 else a).numpy()
            return a

        data = {"origin": host(self.origin), "voxel_size": self.voxel_size,
                "tsdf": host(self.tsdf_vol)}
        for key, value in {**self.attribute_vols, **self.attributes}.items():
            data[key] = host(value)
        np.savez_compressed(fname, **data)

    @classmethod
    def load(cls, fname: str, voxel_types: Optional[list] = None) -> "TSDF":
        """The volume of an npz in the reference layout, on the CPU; the
        'color' and 'instance' volumes when `voxel_types` asks for them
        (None: all), as the reference loads them."""
        with np.load(fname) as data:
            voxel_size = float(data["voxel_size"])
            origin = torch.from_numpy(np.array(data["origin"])).reshape(1, 3)
            tsdf_vol = torch.from_numpy(np.array(data["tsdf"]))
            attribute_vols = {}
            if "color" in data and (voxel_types is None or "color" in voxel_types):
                attribute_vols["color"] = torch.from_numpy(np.array(data["color"]))
            if "instance" in data and (voxel_types is None or "instance" in voxel_types
                                       or "semseg" in voxel_types):
                attribute_vols["instance"] = torch.from_numpy(np.array(data["instance"]))
        return cls(voxel_size, origin, tsdf_vol, attribute_vols)

    def transform(self, transform=None, voxel_dim=None, origin=None) -> "TSDF":
        """Resample the volume onto a `voxel_dim` grid at `origin` under the
        rigid world-frame `transform` (4, 4): nearest on the +-1 plateau
        (unknown or empty), bilinear near the surface, voxels outside the
        old volume set to 1 (empty). Float attribute volumes resample
        bilinearly, the others nearest; 'mask_outside' is True and 'semseg'
        -1 outside. Runs on the host; the result's tensors are on the CPU."""
        def host(x):
            return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)

        old_dim = tuple(int(d) for d in self.tsdf_vol.shape)
        old_origin = host(self.origin).astype(np.float32).reshape(1, 3)
        transform = (np.eye(4, dtype=np.float32) if transform is None
                     else host(transform).astype(np.float32))
        voxel_dim = old_dim if voxel_dim is None else tuple(int(d) for d in voxel_dim)
        origin = old_origin if origin is None else host(origin).astype(np.float32).reshape(1, 3)
        coords, oob = _transform_sample_grid(transform, origin, old_origin, voxel_dim, old_dim,
                                             float(self.voxel_size))

        vol_in = host(self.tsdf_vol).astype(np.float32)[None]
        vol = _resample(vol_in, coords, "nearest")[0]
        band = np.flatnonzero(np.abs(vol) < 1)  # only these take the bilinear value
        vol[band] = _resample(vol_in, coords[:, band], "bilinear")[0]
        vol = np.where(oob, np.float32(1), vol).reshape(voxel_dim)

        attribute_vols = {}
        for key, value in self.attribute_vols.items():
            value = host(value)
            v_in = value.astype(np.float32)
            v_in = v_in[None] if value.ndim == 3 else v_in
            mode = "bilinear" if value.dtype.kind == "f" else "nearest"
            out = _resample(v_in, coords, mode).reshape((-1,) + voxel_dim).astype(value.dtype)
            if value.ndim == 3:
                out = out[0]
            if key == "mask_outside":
                out = np.where(oob.reshape(voxel_dim), True, out).astype(value.dtype)
            elif key == "semseg":
                out = np.where(oob.reshape(voxel_dim), -1, out).astype(value.dtype)
            attribute_vols[key] = torch.from_numpy(np.ascontiguousarray(out))
        return TSDF(self.voxel_size, torch.from_numpy(origin), torch.from_numpy(vol),
                    attribute_vols, dict(self.attributes))

    def get_mesh(self, attribute: str = "color") -> Mesh:
        """The zero level set by marching cubes (the host library), in world
        coordinates (vertices * voxel_size + origin). Voxels at -1 (unknown)
        count as outside, so no surface closes along the unobserved border;
        a volume that does not cross 0 gives an empty mesh. Per-vertex
        'semseg' and 'instance' labels come from the attribute volumes at
        the rounded voxel index; the colours, with attribute 'color', from
        the colour volume (clipped to uint8), with attribute 'semseg', from
        the NYU40 palette of the labels (0 for a label outside it)."""
        tsdf_vol = -np.asarray(self.tsdf_vol.detach().cpu(), np.float32)  # positive outside
        tsdf_vol[tsdf_vol == -1] = 1
        tsdf_vol = np.clip(tsdf_vol, -1, 1)
        if tsdf_vol.min() >= 0 or tsdf_vol.max() <= 0:
            return Mesh(vertices=np.zeros((0, 3)))

        verts, faces = marching_cubes(tsdf_vol, level=0.0)
        i, j, k = np.round(verts).astype(int).T
        origin = np.asarray(self.origin.detach().cpu()).reshape(1, 3)
        verts = verts * self.voxel_size + origin

        vertex_attributes, colors = {}, None
        for key in ("semseg", "instance"):
            if key in self.attribute_vols:
                vertex_attributes[key] = self.attribute_vols[key].cpu().numpy()[i, j, k]
        if attribute == "semseg" and "semseg" in vertex_attributes:
            palette = np.array(NYU40_COLORMAP)
            label = vertex_attributes["semseg"].copy()
            label[(label < 0) | (label >= len(palette))] = 0
            colors = palette[label, :]
        if attribute == "color" and "color" in self.attribute_vols:
            color_vol = np.clip(self.attribute_vols["color"].cpu().numpy(), 0, 255).astype(np.uint8)
            colors = color_vol[:, i, j, k].T
        return Mesh(vertices=verts, faces=faces, vertex_colors=colors,
                    vertex_attributes=vertex_attributes)
