"""``jax.image.resize`` on NHWC images.

The JAX package resizes with ``jax.image.resize`` (``"bilinear"`` in the
guidance encoders, the image-to-3D losses and the CLIP encoders,
``"cubic"`` in the Point-E image grid and the upsample fine-tune).  Its
weights follow ``jax.image.scale_and_translate``: half-pixel centres, the
triangle kernel or Keys' cubic kernel with a = -0.5, the kernel widened
by the shrink factor when an axis shrinks, and each output's weights
normalised over the taps inside the image.  ``F.interpolate`` with
``antialias=True`` computes the same weights (PIL's filters) in both
directions; without it, "bicubic" is a = -0.75 with clamped taps.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

_MODES = {"linear": "bilinear", "bilinear": "bilinear",
          "cubic": "bicubic", "bicubic": "bicubic"}


def resize(x: torch.Tensor, hw: Sequence[int],
           method: str = "bilinear") -> torch.Tensor:
    """[B, H, W, C] -> [B, *hw, C] as ``jax.image.resize(x, (B, *hw, C),
    method)``; the identity at the same size."""
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw),
                      mode=_MODES[method], align_corners=False,
                      antialias=True)
    return y.permute(0, 2, 3, 1)
