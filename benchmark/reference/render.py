"""Gaussian splatting, written out densely: every visible Gaussian at every
pixel, front to back by depth.

The semantics are gsgen's (gs/src/include/vol_render.h and
gs/renderer.py in gsgen3d/gsgen): frustum culling of spheres of
``frustum_culling_radius`` times the largest scale; EWA projection with
the Jacobian held constant and the depth divisor detached; ``G =
exp(-0.5 max(radial, 0))``; alpha clamped to 0.99, a Gaussian with
``alpha G < 1/255`` skipped; compositing stops once the transmittance
before a Gaussian falls under ``T_thresh``; the background enters as
``rgb + T bg``.  Tile culling is part of the result: a Gaussian reaches
only the tiles that the pixel box of its ellipse ``radial <= min(
tile_culling_radius, 2 ln(255 alpha))`` touches (bounds truncated toward
zero), whatever its weight beyond that box.  Pixels run in blocks under
activation checkpointing, so the backward fits at 512^2.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

ALPHA_CLAMP = 0.99
MIN_ALPHA = 1.0 / 255.0
PIXEL_BLOCK = 4096

ACT = {"exp": torch.exp, "sigmoid": torch.sigmoid}


def frustum_cull(mean, radii, c2w, f_static, reso, near, far):
    """gsgen's sphere-vs-frustum test against the static camera."""
    up, right, look, t = -c2w[:, 1], c2w[:, 0], c2w[:, 2], c2w[:, 3]
    yfov = 2.0 * math.atan(reso / (2.0 * f_static))
    hv = far * math.tan(yfov * 0.5)
    hh = hv
    npnt, fpnt = near * look, far * look
    cr = torch.linalg.cross
    normals = torch.stack([look, -look, cr(fpnt - hh * right, up),
                           cr(up, fpnt + hh * right),
                           cr(fpnt + hv * up, right),
                           cr(right, fpnt - hv * up)])
    pts = torch.stack([npnt + t, fpnt + t, t, t, t, t])
    d = mean @ normals.T - (pts * normals).sum(-1)
    return torch.all(d > -radii[:, None], dim=-1)


def project(mean, qvec, svec, c2w, near):
    """(mean2d [N, 2], conic [N, 3], depth [N], in_front [N])."""
    u = (mean - c2w[:3, 3]) @ c2w[:3, :3]
    z = u[:, 2]
    in_front = z > near
    z = torch.where(in_front, z, torch.clamp(z, min=near))
    x, y = u[:, 0], u[:, 1]
    iz = (1.0 / z).detach()
    J = torch.zeros(mean.shape[0], 2, 3, device=mean.device)
    J[:, 0, 0] = iz
    J[:, 1, 1] = iz
    J[:, 0, 2] = (-x * iz * iz).detach()
    J[:, 1, 2] = (-y * iz * iz).detach()
    A = J @ c2w[:3, :3].T                                 # [N, 2, 3]
    q = qvec / torch.clamp(torch.linalg.norm(qvec, dim=-1, keepdim=True),
                           min=1e-12)
    w, i, j, k = q.unbind(-1)
    R = torch.stack([
        1 - 2 * (j * j + k * k), 2 * (i * j - w * k), 2 * (i * k + w * j),
        2 * (i * j + w * k), 1 - 2 * (i * i + k * k), 2 * (j * k - w * i),
        2 * (i * k - w * j), 2 * (j * k + w * i), 1 - 2 * (i * i + j * j),
    ], -1).reshape(-1, 3, 3)
    M = A @ R * svec[:, None, :]                          # [N, 2, 3]
    cov = M @ M.transpose(1, 2)
    c0, c1, c3 = cov[:, 0, 0], cov[:, 0, 1], cov[:, 1, 1]
    det = c0 * c3 - c1 * c1
    det = torch.maximum(det, 1e-6 * (torch.abs(c0 * c3) + torch.abs(c1 * c1))
                        + 1e-38)
    conic = torch.stack([c3 / det, -c1 / det, c0 / det], -1)
    mean2d = torch.stack([x, y], -1) / z.detach()[:, None]
    return mean2d, conic, z, in_front


def _trunc_i64(x):
    """float32 -> integer, truncated toward zero, saturated to int32's
    range, NaN -> 0."""
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    return torch.trunc(torch.clamp(x, -2147483648.0, 2147483647.0)).long()


def tile_boxes(mean2d, conic, alpha, fx, fy, cx, cy, reso, tile, radius):
    """Each Gaussian's inclusive tile box (x0, y0, x1, y1) and whether it
    touches the image."""
    a_cl = torch.clamp(alpha, max=ALPHA_CLAMP)
    D = torch.minimum(torch.tensor(radius, dtype=torch.float32,
                                   device=alpha.device),
                      2.0 * torch.log(torch.clamp(a_cl, min=1e-12)
                                      / MIN_ALPHA))
    ca, cb, cc = conic[:, 0], conic[:, 1], conic[:, 2]
    det = ca * cc - cb * cb
    det = torch.maximum(det, 1e-7 * (torch.abs(ca * cc) + cb * cb) + 1e-38)
    hx = torch.sqrt(torch.clamp(D * cc / det, min=0.0))
    hy = torch.sqrt(torch.clamp(D * ca / det, min=0.0))
    x0 = _trunc_i64((mean2d[:, 0] - hx) * fx + cx)
    y0 = _trunc_i64((mean2d[:, 1] - hy) * fy + cy)
    x1 = _trunc_i64((mean2d[:, 0] + hx) * fx + cx)
    y1 = _trunc_i64((mean2d[:, 1] + hy) * fy + cy)
    inside = ((x1 >= 0) & (x0 <= reso - 1) & (y1 >= 0) & (y0 <= reso - 1)
              & (D >= 0.0))
    box = torch.stack([torch.clamp(v, 0, reso - 1) // tile
                       for v in (x0, y0, x1, y1)], -1)
    return box, inside


def _composite(mean2d, conic, alpha, color, box, pix, ptile,
               T_thresh: float):
    dx = pix[:, None, 0] - mean2d[None, :, 0]
    dy = pix[:, None, 1] - mean2d[None, :, 1]
    radial = (conic[None, :, 0] * dx * dx + 2.0 * conic[None, :, 1] * dx * dy
              + conic[None, :, 2] * dy * dy)
    aG = torch.clamp(alpha, max=ALPHA_CLAMP)[None] * torch.exp(
        -0.5 * torch.clamp(radial, min=0.0))
    tx, ty = ptile[:, None, 0], ptile[:, None, 1]
    hit = ((box[None, :, 0] <= tx) & (tx <= box[None, :, 2])
           & (box[None, :, 1] <= ty) & (ty <= box[None, :, 3]))
    aG = torch.where(hit & (aG >= MIN_ALPHA), aG, torch.zeros_like(aG))
    one = 1.0 - aG
    t_incl = torch.cumprod(one, dim=1)
    t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], 1)
    live = (t_excl >= T_thresh).detach()
    w = torch.where(live, aG * t_excl, torch.zeros_like(aG))
    T = torch.prod(torch.where(live, one, torch.ones_like(one)), dim=1)
    return w @ color, T


def render_view(raw: Dict[str, torch.Tensor], active, view: Dict, bg,
                rcfg: Dict, f_static: float, reso: int, near_plane: float,
                far_plane: float) -> torch.Tensor:
    """One view's rgb [H, W, 3] from the raw fields."""
    mean, qvec = raw["mean"], raw["qvec"]
    svec = ACT[rcfg["svec_act"]](raw["svec"])
    color = ACT[rcfg["color_act"]](raw["color"])
    alpha = ACT[rcfg["alpha_act"]](raw["alpha"])
    c2w = view["c2w"]
    cull = frustum_cull(mean, torch.amax(svec, -1)
                        * rcfg["frustum_culling_radius"], c2w, f_static,
                        reso, near_plane, far_plane)
    mean2d, conic, depth, in_front = project(mean, qvec, svec, c2w,
                                             rcfg.get("near", 1e-3))
    dev = mean.device
    fx, fy, cx, cy = (torch.as_tensor(view[k], dtype=torch.float32,
                                      device=dev)
                      for k in ("fx", "fy", "cx", "cy"))
    tile = int(rcfg["tile_size"])
    box, inside = tile_boxes(mean2d.detach(), conic.detach(),
                             alpha.detach(), fx, fy, cx, cy, reso, tile,
                             float(rcfg["tile_culling_radius"]))
    vis = active & cull & in_front & inside
    idx = torch.nonzero(vis).squeeze(1)
    idx = idx[torch.argsort(depth.detach()[idx], stable=True)]
    ar = torch.arange(reso, device=dev)
    xs = -cx / fx + ar.float() * (1.0 / fx)
    ys = -cy / fy + ar.float() * (1.0 / fy)
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    pix = torch.stack([xg.reshape(-1), yg.reshape(-1)], -1)
    ti, tj = torch.meshgrid(ar // tile, ar // tile, indexing="ij")
    ptile = torch.stack([tj.reshape(-1), ti.reshape(-1)], -1)
    args = (mean2d[idx], conic[idx], alpha[idx], color[idx], box[idx])
    rgbs, Ts = [], []
    for p0 in range(0, pix.shape[0], PIXEL_BLOCK):
        sl = slice(p0, p0 + PIXEL_BLOCK)
        rgb, T = checkpoint(_composite, *args, pix[sl], ptile[sl],
                            float(rcfg["T_thresh"]), use_reentrant=False)
        rgbs.append(rgb)
        Ts.append(T)
    rgb, T = torch.cat(rgbs), torch.cat(Ts)
    return (rgb + T[:, None] * bg[None, :]).reshape(reso, reso, 3)
