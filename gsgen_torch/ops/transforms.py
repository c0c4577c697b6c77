"""Quaternion / rotation / covariance math for 3D Gaussians.

Quaternions are **wxyz**-ordered; the scaled rotation is ``M = R @
diag(s)`` (column scaling), so ``Sigma = M M^T`` (reference
utils/transforms.py:13-60 in gsgen3d/gsgen).
"""

from __future__ import annotations

import torch


def normalize_quat(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize wxyz quaternion(s) along the last axis."""
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                           min=eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """wxyz quaternion(s) ``[..., 4]`` -> rotation matrices ``[..., 3, 3]``
    (normalized internally)."""
    q = normalize_quat(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z),
         2.0 * (x * z + w * y)],
        [2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z),
         2.0 * (y * z - w * x)],
        [2.0 * (x * z - w * y), 2.0 * (y * z + w * x),
         1.0 - 2.0 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quat_scale_to_M(qvec: torch.Tensor, svec: torch.Tensor) -> torch.Tensor:
    """Scaled rotation ``M = R S`` (column j of R scaled by s[j])."""
    return svec[..., None, :] * quat_to_rotmat(qvec)


def quat_scale_to_cov3d(qvec: torch.Tensor,
                        svec: torch.Tensor) -> torch.Tensor:
    """3D covariance ``Sigma = (R S)(R S)^T``  [..., 3, 3]."""
    M = quat_scale_to_M(qvec, svec)
    return M @ M.transpose(-1, -2)
