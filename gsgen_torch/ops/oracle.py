"""Dense O(N * pixels) reference compositor — the port's ground truth.

A direct sequential transcription of the reference compositing
semantics (gs/src/include/vol_render.h:100-166 in gsgen3d/gsgen):
``G = exp(-0.5 * max(radial, 0))``, alpha clamped to 0.99, a Gaussian
with ``alpha * G < 1/255`` is skipped, front-to-back compositing with a
"check before, update after" early exit at ``T < T_thresh``.  It is
differentiable by plain autograd and is the tests' gradient ground
truth.
"""

from __future__ import annotations

from typing import Tuple

import torch

ALPHA_CLAMP = 0.99              # vol_render.h:128
MIN_RENDER_ALPHA = 1.0 / 255.0  # common.h:89
DEFAULT_T_THRESH = 1e-4         # conf/base.yaml:137


def gaussian_weight(mean2d: torch.Tensor, conic: torch.Tensor,
                    pos: torch.Tensor) -> torch.Tensor:
    """Unnormalized 2D Gaussian value at camera-plane positions (shapes
    broadcast)."""
    dx = pos[..., 0] - mean2d[..., 0]
    dy = pos[..., 1] - mean2d[..., 1]
    radial = (conic[..., 0] * dx * dx + 2.0 * conic[..., 1] * dx * dy
              + conic[..., 2] * dy * dy)
    return torch.exp(-0.5 * torch.clamp(radial, min=0.0))


def composite_dense(mean2d, conic, alpha, feats, depth, active, pixels,
                    T_thresh: float = DEFAULT_T_THRESH
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Front-to-back composite of all Gaussians at all pixels.

    Returns (out [P, C], T [P]).  Inactive Gaussians sort to the back with
    zero alpha; depth ties keep ascending index order (stable sort).
    """
    key = torch.where(active, depth, torch.full_like(depth, float("inf")))
    order = torch.argsort(key, stable=True)
    mean2d = mean2d[order]
    conic = conic[order]
    alpha = torch.where(active[order], alpha[order],
                        torch.zeros_like(alpha))
    feats = feats[order]
    a_cl = torch.clamp(alpha, max=ALPHA_CLAMP)

    P = pixels.shape[0]
    T = torch.ones(P, dtype=torch.float32, device=pixels.device)
    acc = torch.zeros(P, feats.shape[-1], dtype=torch.float32,
                      device=pixels.device)
    for g in range(mean2d.shape[0]):
        G = gaussian_weight(mean2d[g], conic[g], pixels)
        aG = a_cl[g] * G
        aG = torch.where(aG < MIN_RENDER_ALPHA, torch.zeros_like(aG), aG)
        live = T >= T_thresh
        w = torch.where(live, aG * T, torch.zeros_like(aG))
        acc = acc + w[:, None] * feats[g][None, :]
        T = torch.where(live, T * (1.0 - aG), T)
    return acc, T


def pixel_grid(intr_topleft, pixel_size, h: int, w: int,
               device="cpu") -> torch.Tensor:
    """Camera-plane positions of all pixels, [H*W, 2], row-major: pixel
    (i, j) -> topleft + (j * psx, i * psy), no half-pixel offset."""
    tx, ty = intr_topleft
    psx, psy = pixel_size
    xs = tx + torch.arange(w, dtype=torch.float32, device=device) * psx
    ys = ty + torch.arange(h, dtype=torch.float32, device=device) * psy
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xg.reshape(-1), yg.reshape(-1)], dim=-1)
