"""Post-training upsample fine-tune.

Port of the JAX package's ``training/upsample.py``: pose set at the final
curriculum -> render at 64² (white background, rgb only) -> upsample to
``reso`` (cached as ``.npy`` when asked) -> optional up-front compactness
densify -> ``epoch`` passes of Adam at one ``lr`` over the scene fields on
``rgb_weight * image_loss(render, target, 0.2, "l2")``, plus
``sds_weight`` x the trainer's guidance loss when that weight is > 0.

The upsampler is pluggable: ``upsample_fn(rgb [B, 64, 64, 3], batch) ->
[B, reso, reso, 3]``.  The default is :func:`bicubic_upsample`, the JAX
package's default; :func:`make_diffusion_upsampler` gives the IF-II-style
diffusion upsampler (:mod:`..guidance.upsampler`) conditioned on the
trainer's prompt.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from ..models.scene import render_batch
from ..ops.camera import CameraIntrinsics
from ..utils.resize import resize
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


def bicubic_upsample(rgb: torch.Tensor, reso: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, reso, reso, C] as ``jax.image.resize(rgb, (B,
    reso, reso, C), "cubic")`` (:func:`..utils.resize.resize`)."""
    return resize(rgb, (reso, reso), "cubic")


def make_diffusion_upsampler(trainer, reso: int,
                             weights_path: Optional[str] = None,
                             num_steps: int = 50,
                             guidance_scale: float = 4.0,
                             generator: Optional[torch.Generator] = None
                             ) -> Callable:
    """IF-II-style ``upsample_fn(rgb, batch)`` on the trainer's device,
    conditioned on the trainer's prompt embedding at each batch's poses
    (view-dependent), drawing from ``generator`` (default: seeded 0):
    ``IF2_PIXEL`` filled from ``weights_path`` (IF-II safetensors), or
    ``TINY_SR`` on random weights."""
    from ..guidance.upsampler import (IF2_PIXEL, TINY_SR, DiffusionUpsampler,
                                      UpsamplerConfig)
    up = DiffusionUpsampler(
        UpsamplerConfig(reso=reso, num_steps=num_steps,
                        guidance_scale=guidance_scale),
        unet_cfg=IF2_PIXEL if weights_path else TINY_SR,
        device=trainer.device)
    if weights_path:
        up.load_weights(weights_path)
    embedding = trainer.prompt_processor()
    if generator is None:
        generator = torch.Generator(device=trainer.device).manual_seed(0)

    def fn(rgb, batch):
        text2 = embedding.get_text_embedding(
            batch["elevation"], batch["azimuth"], batch["camera_distance"],
            True)
        return up.upsample_images(rgb, text2, generator=generator)

    return fn


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
