"""Real spherical-harmonics basis evaluation.

Port of the JAX package's ``ops/sh.py``.  ``eval_sh_basis(dirs, degree)``
returns the first ``degree**2`` real SH basis values of normalized
directions (degree = number of bands, so degree 4 gives 16 coefficients);
``eval_sh_color`` turns per-Gaussian coefficients into a view-dependent
colour ``sigmoid(sum coeffs * Y(dir))``.  The constants are the standard
hard-coded real SH coefficients.
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)
C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
      -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
      0.47308734787878004, -1.7701307697799304, 0.6258357354491761)

MAX_DEGREE = 5  # bands 0..4 -> up to 25 coefficients


def eval_sh_basis(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """dirs [..., 3] (normalized) -> basis [..., degree**2]."""
    if not 1 <= degree <= MAX_DEGREE:
        raise ValueError(f"sh degree {degree} outside 1..{MAX_DEGREE}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, C0)]
    if degree > 1:
        out += [-C1 * y, C1 * z, -C1 * x]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [C2[0] * xy,
                C2[1] * yz,
                C2[2] * (2.0 * zz - xx - yy),
                C2[3] * xz,
                C2[4] * (xx - yy)]
    if degree > 3:
        out += [C3[0] * y * (3.0 * xx - yy),
                C3[1] * xy * z,
                C3[2] * y * (4.0 * zz - xx - yy),
                C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                C3[4] * x * (4.0 * zz - xx - yy),
                C3[5] * z * (xx - yy),
                C3[6] * x * (xx - 3.0 * yy)]
    if degree > 4:
        out += [C4[0] * xy * (xx - yy),
                C4[1] * yz * (3.0 * xx - yy),
                C4[2] * xy * (7.0 * zz - 1.0),
                C4[3] * yz * (7.0 * zz - 3.0),
                C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
                C4[5] * xz * (7.0 * zz - 3.0),
                C4[6] * (xx - yy) * (7.0 * zz - 1.0),
                C4[7] * xz * (xx - 3.0 * yy),
                C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy))]
    return torch.stack(out, dim=-1)


def eval_sh_color(sh_coeffs: torch.Tensor, dirs: torch.Tensor
                  ) -> torch.Tensor:
    """sh_coeffs [..., 3, K], dirs [..., 3] -> rgb [..., 3]."""
    K = sh_coeffs.shape[-1]
    degree = int(round(K ** 0.5))
    if degree * degree != K:
        raise ValueError(f"sh dim {K} must be a square")
    basis = eval_sh_basis(dirs, degree)                  # [..., K]
    y = torch.sum(sh_coeffs * basis[..., None, :], dim=-1)
    return torch.sigmoid(y)
