"""Pinhole camera model and frustum extraction.

``CameraIntrinsics`` is a frozen, hashable dataclass: H/W fix tensor
shapes, while per-sample focal jitter travels as separate scalars.
``c2w`` is a ``[3, 4]`` OpenCV-convention camera-to-world matrix
(columns: right, down, lookat, position).  The camera plane is z=1;
pixel (i, j) maps to ``((j - cx) / fx, (i - cy) / fy)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    """Static camera intrinsics."""

    fx: float
    fy: float
    cx: float
    cy: float
    w: int
    h: int
    near: float = 0.01
    far: float = 1000.0

    @property
    def yfov(self) -> float:
        return 2.0 * math.atan(self.h / (2.0 * self.fy))

    @property
    def aspect(self) -> float:
        return self.w / self.h

    @property
    def pixel_size(self) -> Tuple[float, float]:
        """(pixel_size_x, pixel_size_y) on the z=1 camera plane."""
        return 1.0 / self.fx, 1.0 / self.fy

    @property
    def image_topleft(self) -> Tuple[float, float]:
        """Camera-plane coordinates of pixel (0, 0)."""
        return -self.cx / self.fx, -self.cy / self.fy

    @classmethod
    def from_reso(cls, reso: int, near: float = 0.01, far: float = 1000.0):
        """Square camera with focal = reso."""
        return cls(fx=float(reso), fy=float(reso), cx=reso / 2.0,
                   cy=reso / 2.0, w=reso, h=reso, near=near, far=far)

    @classmethod
    def from_fov(cls, fov: float, aspect: float, resolution: int,
                 near: float = 0.01, far: float = 1000.0):
        """``fov`` (radians) is the horizontal field of view; W =
        ``resolution``, H = ``int(resolution / aspect)``."""
        w = resolution
        h = int(resolution / aspect)
        cx, cy = w / 2.0, h / 2.0
        f = cx / math.tan(fov / 2.0)
        return cls(fx=f, fy=f, cx=cx, cy=cy, w=w, h=h, near=near, far=far)


def get_frustum(c2w: torch.Tensor, intr: CameraIntrinsics
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Six frustum planes as (normals [6,3], points [6,3]); a point q is
    inside iff dot(q - pts_i, n_i) > 0 for all i.  ``up = -c2w[:, 1]``
    because the camera convention is y-down."""
    up = -c2w[:, 1]
    right = c2w[:, 0]
    lookat = c2w[:, 2]
    t = c2w[:, 3]

    half_vside = intr.far * math.tan(intr.yfov * 0.5)
    half_hside = half_vside * intr.aspect

    near_point = intr.near * lookat
    far_point = intr.far * lookat
    cross = torch.linalg.cross
    normals = torch.stack([
        lookat,
        -lookat,
        cross(far_point - half_hside * right, up),
        cross(up, far_point + half_hside * right),
        cross(far_point + half_vside * up, right),
        cross(right, far_point - half_vside * up),
    ], dim=0)
    pts = torch.stack([near_point + t, far_point + t, t, t, t, t], dim=0)
    return normals, pts


def sphere_in_frustum(centers: torch.Tensor, radii: torch.Tensor,
                      normals: torch.Tensor, pts: torch.Tensor
                      ) -> torch.Tensor:
    """Conservative sphere-vs-frustum test: ``dot(c - p_i, n_i) > -r`` for
    every plane, with the reference's unnormalized plane normals."""
    d = centers @ normals.T - (pts * normals).sum(-1)
    return torch.all(d > -radii[:, None], dim=-1)


def get_rays_d(c2w: torch.Tensor, intr: CameraIntrinsics) -> torch.Tensor:
    """Unnormalized world-space ray directions ``[H, W, 3]``: pixel (i, j)
    looks through the camera-plane point ``((j - cx) / fx, (i - cy) / fy,
    1)``, rotated by ``c2w[:3, :3]``."""
    dev = c2w.device
    xs = (torch.arange(intr.w, dtype=torch.float32, device=dev)
          - intr.cx) / intr.fx
    ys = (torch.arange(intr.h, dtype=torch.float32, device=dev)
          - intr.cy) / intr.fy
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")          # [H, W]
    dirs_cam = torch.stack([xg, yg, torch.ones_like(xg)], dim=-1)
    return torch.einsum("ij,hwj->hwi", c2w[:3, :3], dirs_cam)
