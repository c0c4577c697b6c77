"""Backgrounds: ``random`` (a uniform color per training view) and
``fixed``.  Port of the JAX package's ``models/background.py:42-101``; the
learned and MLP backgrounds wait for a later slice.  A background is a
``[3]`` color, composited by the renderer as ``rgb + T * bg``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class BackgroundConfig:
    type: str = "random"                 # random | fixed (ported)
    range: Tuple[float, float] = (0.0, 1.0)
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    initial_color: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    random_aug: bool = False
    random_aug_prob: float = 0.0
    sh_degree: int = 3
    hidden: int = 16
    n_layers: int = 2


def init_background(cfg: BackgroundConfig, device) -> dict:
    """Learnable background params: none for the ported types."""
    if cfg.type not in ("random", "fixed"):
        raise NotImplementedError(f"background type {cfg.type}")
    if cfg.random_aug:
        raise NotImplementedError("background random_aug")
    return {}


def apply_background(params: dict, cfg: BackgroundConfig,
                     generator: torch.Generator, device,
                     training: bool = True) -> torch.Tensor:
    """One view's background color [3]."""
    if cfg.type == "random":
        if not training:
            return torch.zeros(3, dtype=torch.float32, device=device)
        lo, hi = cfg.range
        u = torch.rand(3, generator=generator, dtype=torch.float32,
                       device=device)
        return u * (hi - lo) + lo
    if cfg.type == "fixed":
        return torch.tensor(cfg.color, dtype=torch.float32, device=device)
    raise NotImplementedError(f"background type {cfg.type}")
