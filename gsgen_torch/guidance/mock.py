"""Mock guidance for tests and benchmarks: an L2 pull of every render
toward a target.

Port of the JAX package's ``guidance/mock.py``, both modes:

* ``constant_color``: the target is one colour;
* ``scene``: the target is an ``rgb_only`` render of a frozen target
  scene from the same cameras, on white backgrounds (a small
  reconstruction problem with a known optimum).  When the render's
  resolution differs from ``intr`` (a coarse-to-fine curriculum), the
  target is rendered at the render's resolution; focal and centre come
  from the batch.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models.scene import RenderConfig, render_batch
from ..ops.camera import CameraIntrinsics


class MockGuidance:
    def __init__(self, mode: str = "constant_color",
                 color=(0.8, 0.3, 0.2),
                 target_scene: Optional[Dict[str, torch.Tensor]] = None,
                 target_active: Optional[torch.Tensor] = None,
                 intr: Optional[CameraIntrinsics] = None,
                 rcfg: Optional[RenderConfig] = None):
        if mode not in ("constant_color", "scene"):
            raise ValueError(f"mock guidance mode {mode}")
        if mode == "scene" and any(v is None for v in (
                target_scene, target_active, intr, rcfg)):
            raise ValueError("mock scene mode needs target_scene, "
                             "target_active, intr and rcfg")
        self.mode = mode
        self.color = tuple(float(c) for c in color)
        self.target_scene = target_scene
        self.target_active = target_active
        self.intr = intr
        self.rcfg = rcfg

    def loss(self, rgb: torch.Tensor, *_, c2ws=None, fxs=None, fys=None,
             cxs=None, cys=None, **__) -> Dict[str, torch.Tensor]:
        """``rgb`` [B, H, W, 3] -> {"loss_sds": 0.5 * mean sq. error}; the
        prompt and random arguments of SDS are accepted and unused; the
        ``scene`` mode renders its target from ``c2ws`` and the per-view
        intrinsics."""
        if self.mode == "constant_color":
            target = torch.tensor(self.color, dtype=torch.float32,
                                  device=rgb.device)[None, None, None, :]
        else:
            intr = self.intr
            if intr.h != rgb.shape[1] or intr.w != rgb.shape[2]:
                intr = CameraIntrinsics.from_reso(rgb.shape[1])
            with torch.no_grad():
                target = render_batch(
                    self.target_scene, self.target_active, c2ws, intr,
                    self.rcfg, torch.ones(len(c2ws), 3, device=rgb.device),
                    fxs, fys, cxs, cys, rgb_only=True)["rgb"]
        return {"loss_sds": 0.5 * torch.mean((rgb - target) ** 2)}
