"""OpenCV lens (un)distortion in PyTorch: fixed-iteration Newton solvers.

Port of the JAX package's ``tools/undistort.py`` (reference
utils/undistortion.py in gsgen3d/gsgen, vendored nerfacc / nerfstudio
code).  The Newton loops run a fixed number of iterations of elementwise
tensor math on the device of the points, so everything is differentiable
under autograd (the reference's CUDA path is not).

Parameter conventions match OpenCV / the reference exactly:
  radial-tangential: {k1, k2, p1, p2, k3, k4, k5, k6}, accepted with
    0/1/2/4/8 trailing parameters (zero-padded);
  fisheye: {k1, k2, k3, k4}, theta-polynomial model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _params(params, uv: torch.Tensor, n: int) -> tuple:
    """``params`` broadcast to ``uv``'s points, unbound into ``n``
    tensors of shape ``uv.shape[:-1]``."""
    params = torch.as_tensor(params, dtype=uv.dtype, device=uv.device)
    return torch.broadcast_to(params, uv.shape[:-1] + (n,)).unbind(-1)


def _pad_params(params, uv: torch.Tensor, n: int = 8) -> tuple:
    params = torch.as_tensor(params, dtype=uv.dtype, device=uv.device)
    k = params.shape[-1]
    if k not in (0, 1, 2, 4, 8):
        raise ValueError(f"unsupported distortion parameter count {k}")
    if k < n:
        params = F.pad(params, (0, n - k))
    return _params(params, uv, n)


def _fisheye_params(params, uv: torch.Tensor) -> tuple:
    params = torch.as_tensor(params, dtype=uv.dtype, device=uv.device)
    if params.shape[-1] != 4:
        raise ValueError(f"fisheye expects 4 params, got {params.shape}")
    return _params(params, uv, 4)


def opencv_lens_distortion(uv: torch.Tensor, params) -> torch.Tensor:
    """Apply {k1,k2,p1,p2,k3,k4,k5,k6} distortion to normalized UV
    (reference utils/undistortion.py:85-120, ``_opencv_lens_distortion``)."""
    k1, k2, p1, p2, k3, k4, k5, k6 = _pad_params(params, uv)
    u, v = uv[..., 0], uv[..., 1]
    r2 = u * u + v * v
    radial = (1 + r2 * (k1 + r2 * (k2 + r2 * k3))) / (
        1 + r2 * (k4 + r2 * (k5 + r2 * k6)))
    du = 2 * p1 * u * v + p2 * (r2 + 2 * u * u)
    dv = 2 * p2 * u * v + p1 * (r2 + 2 * v * v)
    return torch.stack([u * radial + du, v * radial + dv], dim=-1)


def opencv_lens_distortion_fisheye(uv: torch.Tensor, params,
                                   eps: float = 1e-10) -> torch.Tensor:
    """Apply fisheye {k1,k2,k3,k4} distortion to normalized UV
    (reference utils/undistortion.py:93-120)."""
    k1, k2, k3, k4 = _fisheye_params(params, uv)
    u, v = uv[..., 0], uv[..., 1]
    r = torch.sqrt(u * u + v * v)
    th = torch.arctan(r)
    th2 = th * th
    th_d = th * (1 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4))))
    scale = th_d / torch.clamp(r, min=eps)
    return uv * scale[..., None]


def _residual_and_jacobian(x, y, xd, yd, p):
    """Residual of the radial-tangential model and its 2x2 Jacobian
    (reference utils/undistortion.py:123-172, nerfstudio math)."""
    k1, k2, p1, p2, k3, k4, k5, k6 = p
    r = x * x + y * y
    alpha = 1.0 + r * (k1 + r * (k2 + r * k3))
    beta = 1.0 + r * (k4 + r * (k5 + r * k6))
    d = alpha / beta

    fx = d * x + 2 * p1 * x * y + p2 * (r + 2 * x * x) - xd
    fy = d * y + 2 * p2 * x * y + p1 * (r + 2 * y * y) - yd

    alpha_r = k1 + r * (2.0 * k2 + r * (3.0 * k3))
    beta_r = k4 + r * (2.0 * k5 + r * (3.0 * k6))
    d_r = (alpha_r * beta - alpha * beta_r) / (beta * beta)
    d_x = 2.0 * x * d_r
    d_y = 2.0 * y * d_r

    fx_x = d + d_x * x + 2.0 * p1 * y + 6.0 * p2 * x
    fx_y = d_y * x + 2.0 * p1 * x + 2.0 * p2 * y
    fy_x = d_x * y + 2.0 * p2 * y + 2.0 * p1 * x
    fy_y = d + d_y * y + 2.0 * p2 * x + 6.0 * p1 * y
    return fx, fy, fx_x, fx_y, fy_x, fy_y


def opencv_lens_undistortion(uv: torch.Tensor, params, eps: float = 1e-6,
                             iters: int = 10) -> torch.Tensor:
    """Invert {k1,k2,p1,p2,k3,k4,k5,k6} distortion by ``iters`` Newton
    iterations (reference utils/undistortion.py:175-211)."""
    p = _pad_params(params, uv)
    x0, y0 = uv[..., 0], uv[..., 1]
    x, y = x0, y0
    for _ in range(iters):
        fx, fy, fx_x, fx_y, fy_x, fy_y = _residual_and_jacobian(
            x, y, x0, y0, p)
        den = fy_x * fx_y - fx_x * fy_y
        ok = torch.abs(den) > eps
        den_safe = torch.where(ok, den, torch.ones_like(den))
        zero = torch.zeros_like(den)
        x, y = (x + torch.where(ok, (fx * fy_y - fy * fx_y) / den_safe, zero),
                y + torch.where(ok, (fy * fx_x - fx * fy_x) / den_safe, zero))
    return torch.stack([x, y], dim=-1)


def opencv_lens_undistortion_fisheye(uv: torch.Tensor, params,
                                     eps: float = 1e-6,
                                     iters: int = 10) -> torch.Tensor:
    """Invert the fisheye theta-polynomial by ``iters`` Newton iterations
    on ``theta_d = theta (1 + k1 th^2 + k2 th^4 + k3 th^6 + k4 th^8)``,
    then rescale the UV ray (reference utils/undistortion.py:50-70, CUDA
    side)."""
    k1, k2, k3, k4 = _fisheye_params(params, uv)
    u, v = uv[..., 0], uv[..., 1]
    th_d = torch.sqrt(u * u + v * v)
    th = th_d
    for _ in range(iters):
        th2 = th * th
        poly = 1 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4)))
        dpoly = (3 * k1 + th2 * (5 * k2 + th2 * (7 * k3 + th2 * 9 * k4)))
        f = th * poly - th_d
        fp = poly + th2 * dpoly
        ok = torch.abs(fp) > eps
        th = th - torch.where(ok, f / torch.where(ok, fp, torch.ones_like(fp)),
                              torch.zeros_like(fp))
    scale = torch.tan(th) / torch.clamp(th_d, min=eps)
    return uv * scale[..., None]
