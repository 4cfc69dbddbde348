"""Image-based geometry: shapes from voxel distance maps (counterpart of
sphinxsys_tpu/core/image.py; reference for_3D_build/geometries/
image_shape.h and image_mhd.h, tests/3d_examples/test_3d_load_image/).

An `ImageShape` holds a 3D voxel image of signed distances; its
`signed_distance` interpolates the image trilinearly
(image_mhd.hpp findValueAndGradientAtPoint), so the normal is the
autograd gradient of the interpolant (`Shape.find_normal_direction`).  A
query outside the voxel lattice is clamped to the border cell and the
Euclidean distance to the clamped point is added.

MetaImage IO (`save_mhd` / `load_mhd`): an ASCII key = value header
(NDims, DimSize, ElementSpacing, Offset, ElementType, ElementDataFile)
and a raw little-endian payload, x fastest-varying (image_mhd.hpp).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Tuple

import numpy as np
import torch

from sphinxsys_tpu_torch.core.geometry import Shape

_MET_TYPES = {"MET_FLOAT": np.float32, "MET_DOUBLE": np.float64,
              "MET_SHORT": np.int16, "MET_UCHAR": np.uint8}


@dataclasses.dataclass(frozen=True, eq=False)
class ImageShape(Shape):
    """Voxel signed-distance-map shape: `data` (nx, ny, nz) numpy, with
    data[i, j, k] the signed distance at origin + (i, j, k) * spacing
    (negative inside)."""

    data: Any
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    name: str = "ImageShape"

    def signed_distance(self, pos):
        img = torch.as_tensor(np.asarray(self.data), device=pos.device).to(
            pos.dtype)
        sp = torch.as_tensor(self.spacing, dtype=pos.dtype, device=pos.device)
        org = torch.as_tensor(self.origin, dtype=pos.dtype, device=pos.device)
        u = (pos - org) / sp
        hi = torch.as_tensor(img.shape, dtype=pos.dtype, device=pos.device) - 1.0
        uc = torch.minimum(torch.clamp(u, min=0.0), hi - 1e-5)
        i0 = torch.floor(uc).long()
        f = uc - i0

        def corner(di, dj, dk):
            return img[i0[..., 0] + di, i0[..., 1] + dj, i0[..., 2] + dk]

        fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
        c00 = corner(0, 0, 0) * (1 - fx) + corner(1, 0, 0) * fx
        c10 = corner(0, 1, 0) * (1 - fx) + corner(1, 1, 0) * fx
        c01 = corner(0, 0, 1) * (1 - fx) + corner(1, 0, 1) * fx
        c11 = corner(0, 1, 1) * (1 - fx) + corner(1, 1, 1) * fx
        c0 = c00 * (1 - fy) + c10 * fy
        c1 = c01 * (1 - fy) + c11 * fy
        sd = c0 * (1 - fz) + c1 * fz
        # a query off the lattice: add its distance to the clamped point (a
        # safe norm, zero with a finite gradient inside)
        d = (u - uc) * sp
        sq = torch.sum(d * d, dim=-1)
        pos_sq = sq > 0
        outside = torch.where(
            pos_sq, torch.sqrt(torch.where(pos_sq, sq, torch.ones_like(sq))),
            torch.zeros_like(sq))
        return sd + outside

    def bounds(self):
        org = np.asarray(self.origin, np.float64)
        ext = (np.asarray(np.asarray(self.data).shape, np.float64) - 1.0) \
            * np.asarray(self.spacing, np.float64)
        return org, org + ext


def sphere_distance_image(shape=(50, 50, 50), spacing=(1.0, 1.0, 1.0),
                          origin=(-24.5, -24.5, -24.5), radius=20.0,
                          center=(0.0, 0.0, 0.0)) -> ImageShape:
    """The procedural stand-in for the reference's sphere.mhd
    (test_3d_load_image/data/sphere.mhd): 50^3 voxels of the float32
    signed distance to a sphere."""
    ax = [origin[d] + spacing[d] * np.arange(shape[d]) for d in range(3)]
    X, Y, Z = np.meshgrid(*ax, indexing="ij")
    c = center
    sd = np.sqrt((X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2) - radius
    return ImageShape(data=sd.astype(np.float32), spacing=spacing,
                      origin=origin)


def save_mhd(path: str, image: ImageShape) -> None:
    """Write the MetaImage pair <path>.mhd + <path>.raw (float32)."""
    base = path[:-4] if path.endswith(".mhd") else path
    data = np.asarray(image.data, np.float32)
    raw_name = os.path.basename(base) + ".raw"
    with open(base + ".raw", "wb") as f:       # x fastest-varying
        f.write(np.ascontiguousarray(data.transpose(2, 1, 0)).tobytes())
    with open(base + ".mhd", "w") as f:
        f.write("ObjectType = Image\nNDims = 3\nBinaryData = True\n"
                "BinaryDataByteOrderMSB = False\n"
                f"DimSize = {data.shape[0]} {data.shape[1]} {data.shape[2]}\n"
                f"ElementSpacing = {image.spacing[0]} {image.spacing[1]} "
                f"{image.spacing[2]}\n"
                f"Offset = {image.origin[0]} {image.origin[1]} "
                f"{image.origin[2]}\n"
                "ElementType = MET_FLOAT\n"
                f"ElementDataFile = {raw_name}\n")


def load_mhd(path: str) -> ImageShape:
    """Read a 3D MetaImage header and its raw distance map into an
    ImageShape (image_mhd.hpp ImageMHD<float, 3>::ImageMHD)."""
    header = {}
    with open(path) as f:
        for line in f:
            if "=" in line:
                k, v = line.split("=", 1)
                header[k.strip()] = v.strip()
    if int(header.get("NDims", "3")) != 3:
        raise ValueError("only 3D MetaImages are supported")
    dims = tuple(int(x) for x in header["DimSize"].split())
    spacing = tuple(float(x) for x in
                    header.get("ElementSpacing", "1 1 1").split())
    origin = tuple(float(x) for x in
                   header.get("Offset", header.get("Origin", "0 0 0")).split())
    dtype = np.dtype(_MET_TYPES[header.get("ElementType", "MET_FLOAT")])
    if header.get("BinaryDataByteOrderMSB", "False") == "True":
        dtype = dtype.newbyteorder(">")
    raw_path = os.path.join(os.path.dirname(path), header["ElementDataFile"])
    data = np.fromfile(raw_path, dtype=dtype)
    if data.size != dims[0] * dims[1] * dims[2]:
        raise ValueError(f"raw payload size {data.size} != DimSize {dims}")
    data = data.reshape(dims[2], dims[1], dims[0]).transpose(2, 1, 0)
    return ImageShape(data=np.asarray(data, np.float32), spacing=spacing,
                      origin=origin)
