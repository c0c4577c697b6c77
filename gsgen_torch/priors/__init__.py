"""3D generative priors: the Point-E text -> and image -> point-cloud inits.

Port of the Point-E half of the JAX package's ``priors/__init__.py``
(reference utils/initialize.py:110-167 and 410-439,
utils/point_e_helper.py).  A cloud is produced once and kept as an asset:
``point_e_generate`` reads ``$GSGEN_ASSET_DIR/point_e_<md5(prompt)[:16]>
.npz`` (keys ``xyz``, ``rgb``; the same file name and format as the JAX
package's, so either package reads the other's cache), else samples it in
process from Point-E checkpoints and writes it there, else raises.
``point_e_image_generate`` does the same for an image (cache
``point_e_image_<md5(key)[:16]>.npz``, the key ``file:<resolved path>``
for a path and ``arr:<md5 of the float32 bytes>`` for an array, as the
JAX package keys it), sampling the image-grid base model and the
grid-conditioned upsampler at CFG 3.0 on the CLIP ViT-L/14 grid.  The
Shap-E, mesh and ``init_asset`` paths wait for later slices.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def _asset_path(prompt: str, kind: str = "point_e") -> Path:
    """``$GSGEN_ASSET_DIR`` (default ``assets/point_clouds``, read at call
    time) / ``<kind>_<md5(prompt)[:16]>.npz``."""
    key = hashlib.md5(prompt.encode()).hexdigest()[:16]
    root = os.environ.get("GSGEN_ASSET_DIR", "assets/point_clouds")
    return Path(root) / f"{kind}_{key}.npz"


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
    CLIP tokenizer and the model-directory loader (``prompt/encoders.py``),
    which are not ported: it raises.  ``base_cfg`` /
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
                f"clip_model_dir {clip_model_dir!r}: the CLIP tokenizer and "
                "model-directory loader that condition Point-E on text are "
                "not ported yet (ROADMAP Queue 1 item 7)")
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


def _image_key(image) -> str:
    if isinstance(image, (str, Path)):
        return f"file:{Path(image).resolve()}"
    return "arr:" + hashlib.md5(
        np.ascontiguousarray(image, np.float32).tobytes()).hexdigest()


def point_e_image_generate(image, num_points: int = 4096,
                           base_weights: Optional[str] = None,
                           upsample_weights: Optional[str] = None,
                           clip_model_dir: Optional[str] = None,
                           base_cfg=None, up_cfg=None, clip_cfg=None,
                           karras_steps: Tuple[int, int] = (64, 64),
                           seed: int = 0, cache: bool = True, device="cuda",
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Image -> coloured point cloud (reference point_e_generate_pcd_from
    _image, utils/point_e_helper.py:64-122).  ``image``: a PNG path or an
    [H, W, 3] float array in [0, 1].

    The asset cache first (:func:`_image_key`); else, with a base
    checkpoint (here or ``GSGEN_POINT_E_IMAGE_BASE``; the upsampler's
    ``GSGEN_POINT_E_UPSAMPLE``) and the ViT-L/14 vision tower's state dict
    (``clip_model_dir``, ``GSGEN_CLIP_VISION_DIR`` or ``GSGEN_CLIP_DIR``: a
    ``.pt`` file in the transformers layout),
    the two stages on ``device`` at CFG 3.0 on the image's CLIP grid
    (the upsampler conditioned on it too), drawing from a generator seeded
    ``seed``; the cloud is cached.  ``base_cfg`` / ``up_cfg`` /
    ``clip_cfg`` replace the full-width configs."""
    p = _asset_path(_image_key(image), "point_e_image")
    if p.exists():
        z = np.load(p)
        return z["xyz"][:num_points], z["rgb"][:num_points]
    base_weights = base_weights or os.environ.get("GSGEN_POINT_E_IMAGE_BASE")
    upsample_weights = (upsample_weights
                        or os.environ.get("GSGEN_POINT_E_UPSAMPLE"))
    clip_model_dir = (clip_model_dir
                      or os.environ.get("GSGEN_CLIP_VISION_DIR")
                      or os.environ.get("GSGEN_CLIP_DIR"))
    if base_weights is None:
        raise FileNotFoundError(
            f"No Point-E image asset at {p} and no image-conditioned "
            "checkpoint configured.  Precompute np.savez(path, xyz=..., "
            "rgb=...), or point GSGEN_POINT_E_IMAGE_BASE at a base40M/"
            "base300M/base1B checkpoint (+GSGEN_POINT_E_UPSAMPLE, "
            "+GSGEN_CLIP_VISION_DIR for the ViT-L/14 tower); "
            "init.point_e_image_base etc. work too.")
    if not clip_model_dir:
        raise FileNotFoundError(
            "the image-grid Point-E init conditions on the CLIP ViT-L/14 "
            "grid: set init.clip_vision_dir or GSGEN_CLIP_VISION_DIR")
    import torch

    from ..guidance.point_e import (BASE40M_IMAGE, UPSAMPLE_CFG,
                                    PointEImageGridModel,
                                    PointEUpsamplerModel)
    from ..prompt.clip_vision import VIT_L14, CLIPImageEncoder
    from .point_e_sampler import PointESampler, PointESamplerConfig

    if isinstance(image, (str, Path)):
        from ..io.logging import read_png
        arr = read_png(image).astype(np.float32) / 255.0
    else:
        arr = np.asarray(image, np.float32)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    arr = np.ascontiguousarray(arr[..., :3])
    clip_cfg = clip_cfg or VIT_L14
    enc = CLIPImageEncoder.from_state_dict(
        clip_model_dir, clip_cfg, projection_dim=768, device=device)
    base_cfg = base_cfg or BASE40M_IMAGE
    grid_tokens = (clip_cfg.image_size // clip_cfg.patch_size) ** 2
    base = PointEImageGridModel(base_cfg, device=device,
                                grid_tokens=grid_tokens
                                ).load_weights(base_weights)
    up = None
    if upsample_weights is not None:
        up = PointEUpsamplerModel(up_cfg or UPSAMPLE_CFG, device=device
                                  ).load_weights(upsample_weights)
    with torch.no_grad():
        cond = enc.encode_grid(torch.as_tensor(arr, device=device)[None])
    del enc
    sampler = PointESampler(base, up, PointESamplerConfig(
        karras_steps=tuple(karras_steps),
        up_guidance_scale=3.0 if up is not None else 0.0,
        up_cond=up is not None))
    gen = torch.Generator(device=device).manual_seed(seed)
    xyz, rgb = sampler.sample_to_cloud(cond, generator=gen)
    if cache:
        p.parent.mkdir(parents=True, exist_ok=True)
        np.savez(p, xyz=xyz, rgb=rgb)
    return xyz[:num_points], rgb[:num_points]


def point_e_image_init_arrays(image, num_points: int = 4096,
                              mean_std: float = 0.6, facex: bool = False,
                              seed: int = 0, **generate_kw
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """``init.type=point_e_image`` arrays (reference point_e_image_
    initialize, utils/initialize.py:410-439): the cloud, padded to
    ``num_points`` by resampling, scaled to a largest norm of
    ``mean_std`` (no centring: the reference skips it on this path) and
    turned by ``facex``."""
    xyz, rgb = point_e_image_generate(image, num_points=num_points,
                                      seed=seed, **generate_kw)
    xyz = np.asarray(xyz, np.float32)
    rgb = np.asarray(rgb, np.float32)
    rng = np.random.default_rng(seed)
    if xyz.shape[0] < num_points:
        idx = rng.integers(0, xyz.shape[0], num_points - xyz.shape[0])
        xyz = np.concatenate([xyz, xyz[idx]], 0)
        rgb = np.concatenate([rgb, rgb[idx]], 0)
    xyz = xyz / (np.linalg.norm(xyz, axis=-1).max() + 1e-5) * mean_std
    if facex:
        x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
        xyz = np.stack([-y, x, z], axis=1)
    return xyz, rgb


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
