"""Make-It-3D guidance: SDS plus CLIP reference losses for image-to-3D.

Port of the JAX package's ``guidance/make_it_3d.py`` (reference
guidance/make_it_3d.py:25-260): novel views are pulled toward the
reference image in CLIP image-embedding space (and, given a prompt
embedding, toward the text), while the original view is supervised
photometrically (:mod:`..training.sit3d`).  The encoder is anything with
``encode(imgs [B, H, W, 3]) -> [B, D]`` (L2-normalized): the CLIP ViT-B/16
tower (:class:`..prompt.clip_vision.CLIPImageEncoder`) or
:class:`MockImageEncoder`, a frozen random patch encoder that gives the
loss a real (if meaningless) landscape.

As in the JAX package, no ``guidance.type`` builds this class and the
trainer passes no ``batch_is_original``: it is driven directly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from ..utils.resize import resize
from .convert import as_tensors
from .sds import SDSConfig, SDSGuidance


class MockImageEncoder:
    """Frozen random patch-embedding encoder -> [B, dim] unit features:
    the image resized to ``reso`` (bilinear, as ``jax.image.resize``),
    ``patch``² patches through ``w`` and a tanh GELU, pooled by ``pool``.
    ``params`` (``w`` [patch²·3, dim], ``pool`` [patches, 1], e.g. the JAX
    encoder's as numpy) replace the draws from a generator seeded 11."""

    def __init__(self, dim: int = 128, patch: int = 8, reso: int = 64,
                 device="cuda", params: Optional[Mapping] = None):
        self.reso = reso
        self.patch = patch
        if params is None:
            g = torch.Generator(device=device).manual_seed(11)
            n_patch = (reso // patch) ** 2
            params = {"w": torch.randn(patch * patch * 3, dim, generator=g,
                                       device=device) * 0.05,
                      "pool": torch.randn(n_patch, 1, generator=g,
                                          device=device) * 0.1}
        self.params = as_tensors(params, device)

    def encode(self, imgs: torch.Tensor) -> torch.Tensor:
        B = imgs.shape[0]
        x = resize(imgs, (self.reso, self.reso))
        p = self.patch
        n = self.reso // p
        x = x.reshape(B, n, p, n, p, 3).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, n * n, p * p * 3)
        feat = F.gelu(x @ self.params["w"], approximate="tanh")
        pooled = torch.sum(feat * self.params["pool"][None], dim=1)
        return pooled / torch.clamp(
            torch.linalg.norm(pooled, dim=-1, keepdim=True), min=1e-8)


@dataclasses.dataclass
class MakeIt3DConfig(SDSConfig):
    clip_weight: float = 1.0


class MakeIt3DGuidance(SDSGuidance):
    """SDS + the CLIP reference loss (get_normal_clip_loss)."""

    def __init__(self, cfg: MakeIt3DConfig, backbone=None,
                 image_encoder=None, ref_image: Optional[torch.Tensor] = None,
                 ref_text_embed: Optional[torch.Tensor] = None,
                 device="cuda"):
        """``ref_image`` [H, W, 3] in [0, 1]; ``ref_text_embed`` [D]: an
        optional L2-normalized CLIP text embedding of the prompt (the
        ``clip_text_loss`` term, make_it_3d.py:258-260)."""
        super().__init__(cfg, backbone, device=device)
        self.image_encoder = image_encoder or MockImageEncoder(device=device)
        self.ref_image = ref_image
        self.ref_text_embed = ref_text_embed

    def clip_ref_loss(self, rgb: torch.Tensor,
                      is_original: torch.Tensor) -> torch.Tensor:
        """Mean over the novel views (``is_original`` 0) of 1 - cos(clip
        (render), clip(ref)), plus 1 - cos(clip(render), text) with a
        prompt embedding."""
        enc = self.image_encoder
        f_r = enc.encode(rgb)
        f_ref = enc.encode(self.ref_image[None])[0]
        dissim = 1.0 - torch.sum(f_r * f_ref[None, :], dim=-1)
        if self.ref_text_embed is not None:
            dissim = dissim + (1.0 - torch.sum(
                f_r * self.ref_text_embed[None, :], dim=-1))
        novel = 1.0 - is_original
        return torch.sum(dissim * novel) / torch.clamp(torch.sum(novel),
                                                       min=1e-6)

    def loss(self, rgb, embedding, elevation, azimuth, camera_distance,
             generator: Optional[torch.Generator] = None,
             sched: Optional[Dict[str, float]] = None,
             batch_is_original: Optional[torch.Tensor] = None, **kw
             ) -> Dict[str, torch.Tensor]:
        """SDS's terms, and ``loss_clip`` = clip_weight x
        :meth:`clip_ref_loss` where a reference image and
        ``batch_is_original`` [B] are given."""
        out = super().loss(rgb, embedding, elevation, azimuth,
                           camera_distance, generator=generator, sched=sched,
                           **kw)
        if self.ref_image is not None and batch_is_original is not None:
            out["loss_clip"] = self.cfg.clip_weight * self.clip_ref_loss(
                rgb, batch_is_original)
        return out
