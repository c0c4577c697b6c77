"""EWA projection of 3D Gaussians to screen space.

Math of the reference ``project_gaussians`` (gs/renderer.py:366-421 in
gsgen3d/gsgen): world -> camera ``x_cam = R^T (x - t)``; the EWA
Jacobian is a constant (``@torch.no_grad`` there, ``.detach()`` here);
``cov2d = (J W) Sigma (J W)^T [:2, :2]``; ``mean2d = xy / z`` with the
divisor detached when ``detach_depth``.  The ``.detach()`` calls sit
exactly where the JAX package has ``stop_gradient``, so the mean/svec
gradients agree.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .transforms import normalize_quat


class ProjectedGaussians(NamedTuple):
    """Screen-space Gaussians (camera-plane units, z=1 plane)."""

    mean2d: torch.Tensor    # [N, 2] camera-plane xy
    cov2d: torch.Tensor     # [N, 2, 2]
    depth: torch.Tensor     # [N] camera-space z (differentiable)
    in_front: torch.Tensor  # [N] bool, z > near


def world_to_camera(points: torch.Tensor, c2w: torch.Tensor) -> torch.Tensor:
    """``x_cam = R^T (x - t)`` for ``c2w`` of shape [3, 4]."""
    return (points - c2w[:3, 3]) @ c2w[:3, :3]


def project_gaussians(mean: torch.Tensor, qvec: torch.Tensor,
                      svec: torch.Tensor, c2w: torch.Tensor,
                      detach_depth: bool = True,
                      near: float = 1e-3) -> ProjectedGaussians:
    """Project 3D Gaussians to the z=1 camera plane.  Gaussians behind the
    camera get ``in_front=False`` and a clamped z so downstream math stays
    finite."""
    u = world_to_camera(mean, c2w)
    z_raw = u[..., 2]
    in_front = z_raw > near
    z_safe = torch.where(in_front, z_raw, torch.clamp(z_raw, min=near))

    # cov2d by elementwise component math (rows 0, 1 of the EWA Jacobian)
    x_c, y_c = u[..., 0], u[..., 1]
    inv_z = (1.0 / z_safe).detach()
    jx = (-x_c * inv_z * inv_z).detach()
    jy = (-y_c * inv_z * inv_z).detach()
    W = c2w[:3, :3].T
    a = [[inv_z * W[i, k] + (jx if i == 0 else jy) * W[2, k]
          for k in range(3)] for i in range(2)]
    q = normalize_quat(qvec)
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = [[1.0 - 2.0 * (qy * qy + qz * qz), 2.0 * (qx * qy - qw * qz),
          2.0 * (qx * qz + qw * qy)],
         [2.0 * (qx * qy + qw * qz), 1.0 - 2.0 * (qx * qx + qz * qz),
          2.0 * (qy * qz - qw * qx)],
         [2.0 * (qx * qz - qw * qy), 2.0 * (qy * qz + qw * qx),
          1.0 - 2.0 * (qx * qx + qy * qy)]]
    b = [[svec[..., k] * (a[i][0] * r[0][k] + a[i][1] * r[1][k]
                          + a[i][2] * r[2][k])
          for k in range(3)] for i in range(2)]
    c00 = b[0][0] * b[0][0] + b[0][1] * b[0][1] + b[0][2] * b[0][2]
    c01 = b[0][0] * b[1][0] + b[0][1] * b[1][1] + b[0][2] * b[1][2]
    c11 = b[1][0] * b[1][0] + b[1][1] * b[1][1] + b[1][2] * b[1][2]
    cov2d = torch.stack([torch.stack([c00, c01], dim=-1),
                         torch.stack([c01, c11], dim=-1)], dim=-2)

    depth = z_safe
    denom = depth.detach() if detach_depth else depth
    mean2d = torch.stack([x_c, y_c], dim=-1) / denom[..., None]
    return ProjectedGaussians(mean2d=mean2d, cov2d=cov2d, depth=depth,
                              in_front=in_front)


def screen_radii(cov2d: torch.Tensor) -> torch.Tensor:
    """Conservative screen radius ``m + sqrt(max(m^2 - det, 0))`` with m
    the mean of the diagonal."""
    m = 0.5 * (cov2d[..., 0, 0] + cov2d[..., 1, 1])
    det = (cov2d[..., 0, 0] * cov2d[..., 1, 1]
           - cov2d[..., 0, 1] * cov2d[..., 1, 0])
    return m + torch.sqrt(torch.clamp(m * m - det, min=0.0))


def conic_from_cov2d(cov2d: torch.Tensor, eps: float = 1e-6
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Invert 2x2 covariances -> conic coefficients (a, b, c) and det.

    The Gaussian weight is ``exp(-0.5 (a dx^2 + 2 b dx dy + c dy^2))``.
    The degeneracy guard is RELATIVE (``eps`` times the magnitude of the
    det's constituent products) and always positive, so sub-pixel
    Gaussians keep their true footprint.
    """
    c0 = cov2d[..., 0, 0]
    c1 = cov2d[..., 0, 1]
    c2 = cov2d[..., 1, 0]
    c3 = cov2d[..., 1, 1]
    det = c0 * c3 - c1 * c2
    floor = eps * (torch.abs(c0 * c3) + torch.abs(c1 * c2)) + 1e-38
    det_safe = torch.maximum(det, floor)
    a = c3 / det_safe
    b = -0.5 * (c1 + c2) / det_safe
    c = c0 / det_safe
    return torch.stack([a, b, c], dim=-1), det
