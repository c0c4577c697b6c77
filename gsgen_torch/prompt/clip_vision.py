"""CLIP vision tower, with the transformers parameter names.

Port of the JAX package's ``prompt/clip_vision.py``: the image encoder of
Make-It-3D's CLIP losses (OpenAI ViT-B/16, reference
guidance/make_it_3d.py:29-57) and of Point-E's image-grid conditioning
(ViT-L/14, point_e/models/pretrained_clip.py).  Parameter names are the
transformers ``CLIPVisionModelWithProjection`` state dict's
(``vision_model.*``, ``visual_projection``); the encoder trunk is
:class:`..prompt.clip.CLIPEncoder`, without a mask.  Images enter NHWC in
[0, 1]; :class:`CLIPImageEncoder` resizes them as ``jax.image.resize``
does (bilinear for the pooled embedding, Keys cubic with a = -0.5 for the
grid: :func:`..utils.resize.resize`) and
normalizes with the CLIP mean and std.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..utils.resize import resize
from .clip import CLIPEncoder, _frozen

# OpenAI CLIP normalization constants (clip/clip.py _transform)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    image_size: int = 224
    patch_size: int = 16
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5


# openai/clip-vit-base-patch16 (the reference's Make-It-3D encoder)
VIT_B16 = CLIPVisionConfig()
# openai/clip-vit-large-patch14 (Point-E image conditioning)
VIT_L14 = CLIPVisionConfig(hidden_size=1024, intermediate_size=4096,
                           num_hidden_layers=24, num_attention_heads=16,
                           patch_size=14)
TINY_VISION = CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                               num_hidden_layers=2, num_attention_heads=2,
                               image_size=32, patch_size=8)


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        n_patches = (cfg.image_size // cfg.patch_size) ** 2
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(n_patches + 1,
                                               cfg.hidden_size)

    def forward(self, pixels):
        """Normalized pixels [B, H, W, 3] -> tokens [B, 1 + P, D]."""
        B = pixels.shape[0]
        patches = self.patch_embedding(pixels.permute(0, 3, 1, 2))
        patches = patches.flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(B, 1, -1)
        x = torch.cat([cls, patches], dim=1)
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        return x + self.position_embedding(pos)


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.embeddings = CLIPVisionEmbeddings(cfg)
        # transformers' own (misspelled) name, kept for the state dict
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=eps)
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=eps)

    def _tokens(self, pixels):
        return self.encoder(self.pre_layrnorm(self.embeddings(pixels)))

    def forward(self, pixels):
        """The pooled class token [B, D], after ``post_layernorm``."""
        return self.post_layernorm(self._tokens(pixels)[:, 0])

    def grid_features(self, pixels):
        """The patch tokens [B, P, D] before ``post_layernorm``: Point-E's
        grid conditioning (pretrained_clip.py:177-214 returns the visual
        transformer's tokens 1: before ln_post)."""
        return self._tokens(pixels)[:, 1:]


class CLIPVisionModelWithProjection(nn.Module):
    """The projected pooled image embedding (OpenAI ``encode_image``)."""

    def __init__(self, cfg: CLIPVisionConfig, projection_dim: int = 512):
        super().__init__()
        self.cfg = cfg
        self.vision_model = CLIPVisionTransformer(cfg)
        self.visual_projection = nn.Linear(cfg.hidden_size, projection_dim,
                                           bias=False)

    def forward(self, pixels):
        return self.visual_projection(self.vision_model(pixels))

    def grid_features(self, pixels):
        return self.vision_model.grid_features(pixels)


def load_clip_vision(state_dict, cfg: CLIPVisionConfig,
                     projection_dim: int = 512, device="cuda"
                     ) -> CLIPVisionModelWithProjection:
    """A frozen :class:`CLIPVisionModelWithProjection` on ``device`` from
    its transformers state dict (or a ``.pt`` file of one)."""
    return _frozen(CLIPVisionModelWithProjection(cfg, projection_dim),
                   state_dict, device)


class CLIPImageEncoder:
    """Make-It-3D's ``encode(imgs)`` and Point-E's ``encode_grid(imgs)``
    over a CLIP vision tower; images [B, H, W, 3] in [0, 1]."""

    def __init__(self, module: CLIPVisionModelWithProjection):
        self.module = module
        self.reso = module.cfg.image_size

    @classmethod
    def from_state_dict(cls, state_dict, cfg: CLIPVisionConfig = VIT_B16,
                        projection_dim: int = 512, device="cuda"):
        return cls(load_clip_vision(state_dict, cfg, projection_dim, device))

    def _pixels(self, imgs, method):
        x = resize(imgs, (self.reso, self.reso), method)
        mean = x.new_tensor(CLIP_IMAGE_MEAN)
        std = x.new_tensor(CLIP_IMAGE_STD)
        return (x - mean) / std

    def encode(self, imgs):
        """L2-normalized projected embeddings [B, projection_dim] (the
        reference normalizes before its cosine losses)."""
        emb = self.module(self._pixels(imgs, "bilinear"))
        return emb / torch.clamp(torch.linalg.norm(emb, dim=-1,
                                                   keepdim=True), min=1e-8)

    def encode_grid(self, imgs):
        """The CLIP patch grid [B, P, D] of Point-E's image conditioning,
        resized bicubically (OpenAI's preprocess uses BICUBIC)."""
        return self.module.grid_features(self._pixels(imgs, "cubic"))
