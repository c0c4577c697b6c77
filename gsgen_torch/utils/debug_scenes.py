"""Deterministic hand-constructed scenes for visual/numeric debugging.

Port of the JAX package's ``utils/debug_scenes.py`` (reference
utils/debug.py:5-40 + the MockRenderer layouts of gs/debug.py:48-128 in
gsgen3d/gsgen): ``one``, ``two``, ``paper``, ``grid`` and ``pressure``.
``pressure`` draws its Gaussians from a ``torch.Generator`` (a CPU one
seeded 0 by default) where the JAX package draws from a key.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.scene import RenderConfig, SceneState, make_scene


def debug_scene(flag: str, rcfg: RenderConfig,
                generator: Optional[torch.Generator] = None,
                n_points: int = 128, bounds: float = 0.5,
                device="cuda") -> SceneState:
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    if flag == "one":
        mean = f32([[0.0, 0.0, 0.0]])
        svec = f32([[0.1, 0.1, 0.2]])
        qvec = f32([[1.0, 0.0, 0.0, 0.0]])
        color = f32([[0.01, 0.01, 0.99]])
        alpha = f32([0.8])
    elif flag == "two":
        mean = f32([[0.0, 0.0, 0.0], [0.0, 0.4, 0.0]])
        svec = torch.full((2, 3), 0.1)
        qvec = f32([[1.0, 0.0, 0.0, 0.0]]).repeat(2, 1)
        color = f32([[0.01, 0.01, 0.99]]).repeat(2, 1)
        alpha = f32([0.8, 0.8])
    elif flag == "paper":
        mean = f32([[0.0, -0.3, 0.2], [0.0, 0.3, -0.1]])
        svec = f32([[0.1, 0.2, 0.1], [0.1, 0.1, 0.2]])
        qvec = f32([[1.0, 1.0, 0.0, 1.0], [1.0, 0.0, 1.0, 0.0]])
        color = f32([[0.0, 0.0, 0.9], [0.0, 0.0, 0.9]])
        alpha = f32([0.9, 0.9])
    elif flag == "grid":
        # gs/debug.py grid layout: a regular lattice of small gaussians
        side = max(int(round(n_points ** (1 / 3))), 2)
        g = (torch.arange(side, dtype=torch.float32) / (side - 1) - 0.5) \
            * 2 * bounds
        gx, gy, gz = torch.meshgrid(g, g, g, indexing="ij")
        mean = torch.stack([gx.reshape(-1), gy.reshape(-1),
                            gz.reshape(-1)], 1)
        n = mean.shape[0]
        svec = torch.full((n, 3), bounds / side * 0.5)
        qvec = torch.zeros((n, 4))
        qvec[:, 0] = 1.0
        color = mean / (2 * bounds) + 0.5
        alpha = torch.full((n,), 0.8)
    elif flag == "pressure":
        gen = generator or torch.Generator().manual_seed(0)
        draw = lambda *s: torch.rand(s, generator=gen,  # noqa: E731
                                     device=gen.device).cpu()
        mean = torch.randn((n_points, 3), generator=gen,
                           device=gen.device).cpu() * bounds
        svec = draw(n_points, 3) * 0.05
        qvec = draw(n_points, 4)
        color = draw(n_points, 3)
        alpha = draw(n_points)
    else:
        raise NotImplementedError(flag)
    dev = torch.device(device)
    return make_scene(*(x.to(dev) for x in (mean, qvec, svec, color,
                                             alpha)), rcfg)
