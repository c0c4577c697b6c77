"""Backgrounds: ``random``, ``fixed``, ``learned_const`` and ``mlp``, with
the ``random_aug`` wrapper.

Port of the JAX package's ``models/background.py``.  A background is a
``[3]`` colour or an ``[H, W, 3]`` image, composited by the renderer as
``rgb + T * bg``.  ``init_background`` makes the learnable params (none,
``bg_color``, or the MLP's ``w{i}`` / ``b{i}``); ``apply_background``
gives one view's background.  The MLP reads SH features
(:func:`..ops.sh.eval_sh_basis`) of the normalized ray directions.

Draws come from an explicit ``torch.Generator``: ``random`` takes 3
uniforms; ``random_aug`` takes 3 more (``rand_color``) and uses the
model's background exactly when ``rand_color[0] < random_aug_prob``.  That
coupling is the JAX package's: it draws the colour and the coin from one
key, and ``uniform(k, ())`` equals ``uniform(k, (3,))[0]``.  ``u=`` [6]
injects the uniforms instead (``u[:3]`` the ``random`` colour's, ``u[3:]``
the wrapper's), so tests can feed the JAX package's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.sh import eval_sh_basis


@dataclasses.dataclass(frozen=True)
class BackgroundConfig:
    type: str = "random"                 # random | fixed | learned_const | mlp
    range: Tuple[float, float] = (0.0, 1.0)   # random colour range
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)   # fixed
    # learned_const
    initial_color: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    random_aug: bool = False
    random_aug_prob: float = 0.0
    # mlp
    sh_degree: int = 3
    hidden: int = 16
    n_layers: int = 2


TYPES = ("random", "fixed", "learned_const", "mlp")


def init_background(cfg: BackgroundConfig, generator: torch.Generator,
                    device) -> Dict[str, torch.Tensor]:
    """Learnable background params: ``bg_color`` [3] for
    ``learned_const``; He-normal ``w{i}`` [a, b] and zero ``b{i}`` for the
    ``mlp`` (SH features -> ``hidden`` x ``n_layers`` -> 3); none
    otherwise."""
    if cfg.type not in TYPES:
        raise NotImplementedError(f"background type {cfg.type}")
    f32 = dict(dtype=torch.float32, device=device)
    if cfg.type == "learned_const":
        return {"bg_color": torch.tensor(cfg.initial_color, **f32)}
    if cfg.type != "mlp":
        return {}
    dims = [cfg.sh_degree ** 2] + [cfg.hidden] * cfg.n_layers + [3]
    params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"w{i}"] = torch.randn(a, b, generator=generator,
                                      **f32) * (2.0 / a) ** 0.5
        params[f"b{i}"] = torch.zeros(b, **f32)
    return params


def background_from_numpy(arrays: Dict[str, np.ndarray], device
                          ) -> Dict[str, torch.Tensor]:
    """Background params from the JAX package's ``init_background`` leaves
    as numpy arrays (same names)."""
    return {k: torch.as_tensor(np.array(v), dtype=torch.float32,
                               device=device) for k, v in arrays.items()}


def mlp_background(params: Dict[str, torch.Tensor], sh_degree: int,
                   dirs: torch.Tensor) -> torch.Tensor:
    """[..., 3] ray directions -> [..., 3] colours in [0, 1]."""
    d = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True),
                           min=1e-8)
    x = eval_sh_basis(d, sh_degree)
    n_layers = sum(1 for k in params if k.startswith("w")) - 1
    for i in range(n_layers):
        x = torch.relu(x @ params[f"w{i}"] + params[f"b{i}"])
    x = x @ params[f"w{n_layers}"] + params[f"b{n_layers}"]
    return torch.nan_to_num(torch.sigmoid(x))


def _uniforms(generator, device, u, lo: int) -> torch.Tensor:
    if u is not None:
        return torch.as_tensor(u, dtype=torch.float32,
                               device=device)[lo:lo + 3]
    return torch.rand(3, generator=generator, dtype=torch.float32,
                      device=device)


def apply_background(params: Dict[str, torch.Tensor], cfg: BackgroundConfig,
                     generator: Optional[torch.Generator], device,
                     dirs: Optional[torch.Tensor] = None,
                     training: bool = True,
                     u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One view's background: a colour [3], or an image [H, W, 3] for the
    ``mlp`` (``dirs`` [H, W, 3], e.g. :func:`..ops.camera.get_rays_d`)."""
    if cfg.type == "random":
        if training:
            lo, hi = cfg.range
            bg = _uniforms(generator, device, u, 0) * (hi - lo) + lo
        else:
            bg = torch.zeros(3, dtype=torch.float32, device=device)
    elif cfg.type == "fixed":
        return torch.tensor(cfg.color, dtype=torch.float32, device=device)
    elif cfg.type == "learned_const":
        bg = params["bg_color"]
    elif cfg.type == "mlp":
        bg = mlp_background(params, cfg.sh_degree, dirs)
    else:
        raise NotImplementedError(f"background type {cfg.type}")
    if cfg.random_aug and training:
        # the JAX package's coin is rand_color[0] (one key for both draws)
        rand_color = _uniforms(generator, device, u, 3)
        bg = torch.where(rand_color[0] < cfg.random_aug_prob, bg,
                         rand_color if bg.dim() == 1
                         else rand_color[None, None, :])
    return bg
