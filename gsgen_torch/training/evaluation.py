"""Periodic evaluation: eval images and orbit videos.

Port of the JAX package's ``training/evaluation.py``.  One view at a time
under ``torch.no_grad()`` on the device of the scene: zero background, the
rgb clamped to [0, 1]; the eval image renders every channel and becomes
an rgb | depth | opacity | z_var strip, the orbit frames render
``rgb_only``.  Each frame comes to the host as it is done.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.scene import RenderConfig, SceneState, render_view
from ..ops.camera import CameraIntrinsics
from ..utils.colormaps import eval_image_strip
from ..utils.spiral import (camera_path_fixed_elevation,
                            random_pose_fixed_elevation)


@torch.no_grad()
def _render_eval(state: SceneState, c2w, intr: CameraIntrinsics,
                 cfg: RenderConfig, rgb_only: bool = False):
    dev = state.params["mean"].device
    out = render_view(state.params, state.active,
                      torch.as_tensor(c2w, dtype=torch.float32, device=dev),
                      intr, cfg, torch.zeros(3, device=dev),
                      rgb_only=rgb_only)
    out["rgb"] = torch.clamp(out["rgb"], 0.0, 1.0)
    return out


def eval_image(state: SceneState, intr: CameraIntrinsics, cfg: RenderConfig,
               rng: np.random.Generator, elevation: float = 45.0,
               camera_distance: float = 2.5) -> np.ndarray:
    """The eval strip of one view at a random azimuth drawn from ``rng``."""
    c2w = random_pose_fixed_elevation(rng, camera_distance, elevation)
    out = _render_eval(state, c2w, intr, cfg)
    return eval_image_strip({k: v.cpu().numpy() for k, v in out.items()
                             if v.dim() >= 2})


def eval_video(state: SceneState, intr: CameraIntrinsics, cfg: RenderConfig,
               n_frames: int = 30, n_circles: int = 1,
               elevation: float = 45.0,
               camera_distance: float = 2.5) -> np.ndarray:
    """Orbit frames [T, H, W, 3]."""
    c2ws = camera_path_fixed_elevation(n_frames, n_circles, camera_distance,
                                       elevation)
    return np.stack([_render_eval(state, c2w, intr, cfg, rgb_only=True)
                     ["rgb"].cpu().numpy() for c2w in c2ws])
