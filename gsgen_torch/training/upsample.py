"""Post-training upsample fine-tune.

Port of the JAX package's ``training/upsample.py``: pose set at the final
curriculum -> render at 64² (white background, rgb only) -> upsample to
``reso`` (cached as ``.npy`` when asked) -> optional up-front compactness
densify -> ``epoch`` passes of Adam at one ``lr`` over the scene fields on
``rgb_weight * image_loss(render, target, 0.2, "l2")``, plus
``sds_weight`` x the trainer's guidance loss when that weight is > 0.

The upsampler is pluggable: ``upsample_fn(rgb [B, 64, 64, 3], batch) ->
[B, reso, reso, 3]``.  The default is :func:`bicubic_upsample`, the JAX
package's default; its diffusion upsampler (IF-II) is not ported
(:func:`make_diffusion_upsampler` raises).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from ..models.scene import render_batch
from ..ops.camera import CameraIntrinsics
from .losses import image_loss
from .optimizer import adam_init, adam_update


@dataclasses.dataclass
class UpsampleTuneConfig:
    """The ``upsample_tune`` keys of the configs (``enabled`` aside)."""

    num_poses: int = 64
    batch_size: int = 4
    reso: int = 256
    epoch: int = 10
    lr: float = 0.005
    rgb_weight: float = 1.0
    sds_weight: float = 0.0
    use_cache: bool = True
    cache_dir: str = "tmp/upsample_cache"
    densify_compactness: bool = False


def _cubic_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] float32 weights of ``jax.image.resize(..., "cubic")``
    along one axis: the Keys kernel with a = -0.5 at half-pixel centres,
    each output's weights renormalised to sum to 1 (taps outside the image
    drop out, so the border is not clamped), 0 for an output centre
    outside the input."""
    f32 = dict(dtype=torch.float32, device=device)
    inv_scale = 1.0 / torch.tensor(n_out / n_in, **f32)
    sample = (torch.arange(n_out, **f32) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample[None, :] - torch.arange(n_in, **f32)[:, None])
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = torch.where(x >= 2.0, torch.zeros_like(w), w)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def bicubic_upsample(rgb: torch.Tensor, reso: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, reso, reso, C] as ``jax.image.resize(rgb, (B,
    reso, reso, C), "cubic")``: a separable product with
    :func:`_cubic_weights` along H and W (``interpolate(mode="bicubic")``
    uses a = -0.75 and clamps at the border, so it is not used)."""
    wh = _cubic_weights(rgb.shape[1], reso, rgb.device)
    ww = _cubic_weights(rgb.shape[2], reso, rgb.device)
    return torch.einsum("bhwc,hy,wx->byxc", rgb, wh, ww)


def make_diffusion_upsampler(trainer, reso: int, *args, **kwargs):
    raise NotImplementedError(
        "the diffusion upsampler (DeepFloyd IF-II) is not ported yet "
        "(ROADMAP Queue 1 item 6); the fine-tune's default is "
        "bicubic_upsample")


def tune_with_upsample(trainer, cfg: UpsampleTuneConfig,
                       upsample_fn: Optional[Callable] = None,
                       cache_uid: Optional[str] = None) -> List[float]:
    """Run the upsample fine-tune on a trained ``Trainer``; returns the
    loss of every step."""
    upsample_fn = upsample_fn or (
        lambda rgb, batch: bicubic_upsample(rgb, cfg.reso))
    dev = trainer.device
    data = trainer.data
    data.update(trainer.cfg.max_steps)
    n_batches = cfg.num_poses // cfg.batch_size
    batches = [{k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                for k, v in data.get_batch(cfg.batch_size).items()}
               for _ in range(n_batches)]
    lo_intr = CameraIntrinsics.from_reso(64)
    hi_intr = CameraIntrinsics.from_reso(cfg.reso)
    white = torch.ones(cfg.batch_size, 3, device=dev)
    scene = trainer.state.scene

    cache = None
    if cfg.use_cache and cache_uid:
        cache = Path(cfg.cache_dir) / f"{cache_uid}.npy"
    if cache is not None and cache.exists():
        upsampled = torch.as_tensor(np.load(cache), device=dev)
    else:
        with torch.no_grad():
            upsampled = torch.cat([upsample_fn(render_batch(
                scene.params, scene.active, b["c2w"], lo_intr, trainer.rcfg,
                white, rgb_only=True)["rgb"], b) for b in batches])
        if cache is not None:
            cache.parent.mkdir(parents=True, exist_ok=True)
            np.save(cache, upsampled.cpu().numpy())

    if cfg.densify_compactness:
        from ..models.density import (DensifyConfig, densify_compactness,
                                      reset_densify_stats)
        scene, _, _ = densify_compactness(scene, trainer.state.opt,
                                          DensifyConfig(), trainer.rcfg, K=3)
        scene = reset_densify_stats(scene)
        trainer.state = dataclasses.replace(trainer.state, scene=scene)

    # the SDS term reuses the trainer's guidance and prompt; a zero weight
    # never runs the UNet
    guidance = trainer.guidance if cfg.sds_weight > 0.0 else None
    embedding = (trainer.prompt_processor()
                 if guidance is not None
                 and trainer.prompt_processor is not None else None)
    sds_sched = (guidance.sched_scalars(trainer.cfg.max_steps,
                                        trainer.cfg.max_steps)
                 if guidance is not None
                 and hasattr(guidance, "sched_scalars") else None)

    params = {k: v.detach().clone() for k, v in scene.params.items()}
    opt = adam_init(params)
    losses = []
    for _ in range(cfg.epoch):
        for i, b in enumerate(batches):
            tgt = upsampled[i * cfg.batch_size:(i + 1) * cfg.batch_size]
            p = {k: v.requires_grad_(True) for k, v in params.items()}
            rgb = render_batch(p, scene.active, b["c2w"], hi_intr,
                               trainer.rcfg, white, rgb_only=True)["rgb"]
            per = torch.stack([image_loss(rgb[j], tgt[j], 0.2, "l2")
                               for j in range(rgb.shape[0])])
            loss = cfg.rgb_weight * torch.mean(per)
            if guidance is not None:
                g = guidance.loss(
                    rgb, embedding, b["elevation"], b["azimuth"],
                    b["camera_distance"], generator=trainer.generator,
                    sched=sds_sched, c2ws=b["c2w"],
                    train=getattr(guidance, "trainable_params", {}))
                loss = loss + cfg.sds_weight * (g.get("loss_sds", 0.0)
                                                + g.get("loss_vsd", 0.0))
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            params, opt = adam_update(grads, opt, params, cfg.lr)
            losses.append(float(loss.detach()))
    trainer.state = dataclasses.replace(
        trainer.state, scene=dataclasses.replace(scene, params=params))
    return losses
