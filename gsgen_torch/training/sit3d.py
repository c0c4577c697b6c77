"""Image-to-3D ("sit3d"): the depth-lifted init, the original-view losses
and the front-point gradient mask.

Port of the JAX package's ``training/sit3d.py`` (reference
utils/initialize.py:359-407, trainer.py:623-734 and
gs/gaussian_splatting.py:341-366 of gsgen3d/gsgen).  The front points are
the input image's foreground pixels lifted along their rays to the
monocular depth, thinned by farthest point sampling; the back points lie
on the semisphere behind them.  The trainer freezes the front rows by
zeroing their gradient while the mask window is on
(:meth:`..training.trainer.Trainer._train_step`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.init import InitConfig, sphere_points
from ..models.scene import RenderConfig, SceneState, make_scene
from ..ops.camera import CameraIntrinsics, get_rays_d
from ..utils.ops import farthest_point_sampling
from ..utils.resize import resize
from .losses import image_loss, pearson_depth_loss


class ImageTarget(NamedTuple):
    """The reference view: ``image`` [H, W, 3] in [0, 1], ``depth`` [H, W]
    and the foreground ``mask`` [H, W] (bool)."""

    image: torch.Tensor
    depth: torch.Tensor
    mask: torch.Tensor


def lift_to_3d(depth: torch.Tensor, intr: CameraIntrinsics,
               c2w: torch.Tensor) -> torch.Tensor:
    """World points [H, W, 3] of a depth map along the unnormalized rays
    (kornia's ``depth_to_3d``, as utils/initialize.py:370 uses it)."""
    dirs = get_rays_d(c2w, intr)
    return c2w[:3, 3][None, None, :] + dirs * depth[..., None]


def image_initialize(cfg: InitConfig, rcfg: RenderConfig,
                     target: ImageTarget, intr: CameraIntrinsics,
                     c2w: torch.Tensor, generator: torch.Generator,
                     grad_mask: bool = True,
                     back_mean: Optional[np.ndarray] = None,
                     back_rgb: Optional[np.ndarray] = None
                     ) -> Tuple[SceneState, Optional[torch.Tensor]]:
    """The scene of ``min(num_points, H·W)`` front points (farthest point
    sampling over the foreground pixels, lifted; their image colours) and
    ``num_points`` back points on the semisphere of radius ``mean_std``
    with uniform colours, and the gradient mask [capacity] (True: a
    frozen front row) or None.  The foreground is found by a stable
    argsort of ``~mask``, so the FPS mask is the first ``n_fg`` rows.
    ``back_mean`` [n, 3] / ``back_rgb`` [n, 3] replace the draws from
    ``generator``."""
    dev = target.image.device
    f32 = dict(dtype=torch.float32, device=dev)
    pts = lift_to_3d(target.depth, intr, c2w).reshape(-1, 3)
    rgb = target.image.reshape(-1, 3)
    m = target.mask.reshape(-1)
    order = torch.argsort((~m).to(torch.uint8), stable=True)
    pts, rgb = pts[order], rgb[order]
    n_front = min(cfg.num_points, int(pts.shape[0]))
    fg = torch.arange(pts.shape[0], device=dev) < torch.sum(m)
    idx = farthest_point_sampling(pts, n_front, mask=fg).long()
    n = cfg.num_points
    if back_mean is None:
        u1, u2 = (torch.rand(n, generator=generator, **f32)
                  for _ in range(2))
        back = sphere_points(u1, u2, cfg.mean_std, semi=True)
    else:
        back = torch.as_tensor(np.array(back_mean), **f32)
    if back_rgb is None:
        back_col = torch.rand(n, 3, generator=generator, **f32)
    else:
        back_col = torch.as_tensor(np.array(back_rgb), **f32)
    mean = torch.cat([pts[idx], back])
    color = torch.cat([rgb[idx], back_col])
    total = mean.shape[0]
    qvec = torch.zeros(total, 4, **f32)
    qvec[:, 0] = 1.0
    svec = torch.full((total, 3), cfg.svec_val, **f32)
    alpha = torch.full((total,), cfg.alpha_val, **f32)
    state = make_scene(mean, qvec, svec, color, alpha, rcfg,
                       capacity=cfg.capacity or total)
    gmask = None
    if grad_mask:
        cap = state.params["mean"].shape[0]
        gmask = torch.arange(cap, device=dev) < n_front
    return state, gmask


def sit3d_losses(outs: Dict[str, torch.Tensor],
                 batch: Dict[str, torch.Tensor],
                 target: ImageTarget) -> Dict[str, torch.Tensor]:
    """The original-view image loss (0.2 SSIM + 0.8 L2) and Pearson depth
    loss (trainer.py:659-690) of every view, weighted by its
    ``is_original`` and averaged over the original views; the target is
    resized to the render as ``jax.image.resize(..., "bilinear")``."""
    H = outs["rgb"].shape[1]
    img = resize(target.image[None], (H, H))[0]
    dep = resize(target.depth[None, ..., None], (H, H))[0, ..., 0]
    is_orig = batch["is_original"]
    n_orig = torch.clamp(torch.sum(is_orig), min=1e-6)
    per_img = torch.stack([image_loss(r, img, 0.2, "l2")
                           for r in outs["rgb"]])
    per_dep = torch.stack([pearson_depth_loss(d, dep)
                           for d in outs["depth"]])
    return {"loss_image": torch.sum(per_img * is_orig) / n_orig,
            "loss_depth": torch.sum(per_dep * is_orig) / n_orig}
