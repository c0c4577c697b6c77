"""3D generative priors: the Point-E text -> point-cloud init.

Port of the Point-E half of the JAX package's ``priors/__init__.py``
(reference utils/initialize.py:110-167, utils/point_e_helper.py).  A
cloud is produced once and kept as an asset: ``point_e_generate`` reads
``$GSGEN_ASSET_DIR/point_e_<md5(prompt)[:16]>.npz`` (keys ``xyz``,
``rgb``; the same file name and format as the JAX package's, so either
package reads the other's cache), else samples it in process from
Point-E checkpoints and writes it there, else raises.  The Shap-E, mesh,
image and ``init_asset`` paths wait for later slices.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def _asset_path(prompt: str) -> Path:
    """``$GSGEN_ASSET_DIR`` (default ``assets/point_clouds``, read at call
    time) / ``point_e_<md5(prompt)[:16]>.npz``."""
    key = hashlib.md5(prompt.encode()).hexdigest()[:16]
    root = os.environ.get("GSGEN_ASSET_DIR", "assets/point_clouds")
    return Path(root) / f"point_e_{key}.npz"


def point_e_generate(prompt: str, num_points: int = 4096,
                     base_weights: Optional[str] = None,
                     upsample_weights: Optional[str] = None,
                     clip_model_dir: Optional[str] = None,
                     karras_steps: Tuple[int, int] = (64, 64),
                     base_cfg=None, up_cfg=None, device="cuda",
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Text -> coloured point cloud (xyz [N, 3], rgb [N, 3] in [0, 1]).

    Resolution order, as in the JAX package:

    1. the asset cache (:func:`_asset_path`);
    2. the in-process two-stage sampler on ``device``
       (:mod:`.point_e_sampler`) when a base checkpoint is given, here or
       by ``GSGEN_POINT_E_BASE`` (the upsampler's by
       ``GSGEN_POINT_E_UPSAMPLE``); the cloud is written to the cache;
    3. otherwise ``FileNotFoundError``.

    Text conditioning (``clip_model_dir`` / ``GSGEN_CLIP_DIR``) needs the
    CLIP text tower, which is not ported: it raises.  ``base_cfg`` /
    ``up_cfg`` replace the full-width configs (the tests' TINY ones).
    """
    p = _asset_path(prompt)
    if p.exists():
        z = np.load(p)
        return z["xyz"][:num_points], z["rgb"][:num_points]

    base_weights = base_weights or os.environ.get("GSGEN_POINT_E_BASE")
    upsample_weights = (upsample_weights
                        or os.environ.get("GSGEN_POINT_E_UPSAMPLE"))
    clip_model_dir = clip_model_dir or os.environ.get("GSGEN_CLIP_DIR")
    if base_weights is not None:
        if clip_model_dir:
            raise NotImplementedError(
                f"clip_model_dir {clip_model_dir!r}: the CLIP text tower "
                "that conditions Point-E is not ported yet (ROADMAP Queue 1 "
                "item 7)")
        xyz, rgb = _point_e_sample_in_process(
            base_weights, upsample_weights, karras_steps, base_cfg, up_cfg,
            device)
        p.parent.mkdir(parents=True, exist_ok=True)
        np.savez(p, xyz=xyz, rgb=rgb)
        return xyz[:num_points], rgb[:num_points]

    raise FileNotFoundError(
        f"No Point-E asset for prompt {prompt!r} at {p} and no "
        "checkpoints configured. Either precompute the cloud and save "
        "np.savez(path, xyz=..., rgb=...), or point GSGEN_POINT_E_BASE/"
        "GSGEN_POINT_E_UPSAMPLE (+GSGEN_CLIP_DIR for text conditioning) "
        "at point-e checkpoints (init.point_e_base/init.point_e_upsample "
        "config keys work too); or use init.type=base/unisphere/"
        "semisphere/box.")


def _point_e_sample_in_process(base_weights, upsample_weights,
                               karras_steps, base_cfg, up_cfg, device):
    """The two-stage sampler on checkpoints, unconditioned (zero text
    vector), with its draws from a generator seeded 0 (the JAX package's
    key)."""
    import torch

    from ..guidance.point_e import (BASE40M_TEXTVEC, UPSAMPLE_CFG,
                                    PointEModel, PointEUpsamplerModel)
    from .point_e_sampler import PointESampler, PointESamplerConfig

    base = PointEModel(base_cfg or BASE40M_TEXTVEC, device=device
                       ).load_weights(base_weights)
    up = None
    if upsample_weights is not None:
        up = PointEUpsamplerModel(up_cfg or UPSAMPLE_CFG, device=device
                                  ).load_weights(upsample_weights)
    sampler = PointESampler(base, up, PointESamplerConfig(
        karras_steps=tuple(karras_steps)))
    gen = torch.Generator(device=device).manual_seed(0)
    return sampler.sample_to_cloud(generator=gen)


def point_e_init_arrays(prompt: str, num_points: int = 4096,
                        mean_std: float = 0.6, z_scale: float = 1.0,
                        random_exceed: bool = False, seed: int = 0,
                        **generate_kw) -> Tuple[np.ndarray, np.ndarray]:
    """A Point-E cloud normalised for scene init (reference
    utils/initialize.py:110-167): padded to ``num_points`` (resampled with
    ``random_exceed``, else normal extras and random colours), centred,
    scaled to a largest norm of ``mean_std``, z scaled by ``z_scale``; the
    facex rotation is ``init.facex``'s, downstream."""
    xyz, rgb = point_e_generate(prompt, num_points=4096, **generate_kw)
    xyz = np.asarray(xyz, np.float32)
    rgb = np.asarray(rgb, np.float32)
    rng = np.random.default_rng(seed)
    if num_points > xyz.shape[0]:
        if random_exceed:
            idx = rng.integers(0, xyz.shape[0], num_points)
            xyz, rgb = xyz[idx], rgb[idx]
        else:
            extra = num_points - xyz.shape[0]
            xyz = np.concatenate(
                [xyz, rng.normal(size=(extra, 3)).astype(np.float32)
                 * mean_std], 0)
            rgb = np.concatenate(
                [rgb, rng.random((extra, 3), dtype=np.float32)], 0)
    else:
        xyz, rgb = xyz[:num_points], rgb[:num_points]
    xyz = xyz - xyz.mean(axis=0, keepdims=True)
    xyz = xyz / (np.linalg.norm(xyz, axis=-1).max() + 1e-5) * mean_std
    xyz[..., 2] *= z_scale
    return xyz, rgb
