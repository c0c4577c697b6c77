"""Mock guidance: an L2 pull of every render toward a constant color.

Port of the ``constant_color`` mode of the JAX package's
``guidance/mock.py``; its ``scene`` mode waits for a later slice.
"""

from __future__ import annotations

from typing import Dict

import torch


class MockGuidance:
    def __init__(self, mode: str = "constant_color",
                 color=(0.8, 0.3, 0.2)):
        if mode != "constant_color":
            raise NotImplementedError(f"mock guidance mode {mode}")
        self.color = tuple(float(c) for c in color)

    def loss(self, rgb: torch.Tensor, *_, **__) -> Dict[str, torch.Tensor]:
        """``rgb`` [B, H, W, 3] -> {"loss_sds": 0.5 * mean sq. error}; the
        prompt, camera and random arguments of SDS are accepted and
        unused."""
        target = torch.tensor(self.color, dtype=torch.float32,
                              device=rgb.device)[None, None, None, :]
        return {"loss_sds": 0.5 * torch.mean((rgb - target) ** 2)}
