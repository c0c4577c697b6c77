"""CLIP text encoder, with the transformers parameter names.

Port of the JAX package's ``prompt/clip.py`` (the reference encodes
prompts with transformers' ``CLIPTextModel``).  Module and parameter
names are the transformers state dict's (``text_model.embeddings.*``,
``text_model.encoder.layers.N.self_attn.q_proj``, ...), so one state dict
fills this module and the JAX package's flax tree.  The attention is a
plain matmul and an fp32 softmax, as the JAX module writes it (no fused
kernel: the JAX module reaches none).  The encoder trunk
(:class:`CLIPEncoder`) is shared with the vision tower
(:mod:`.clip_vision`).

SD 1.x uses openai/clip-vit-large-patch14 (768 wide, 12 layers,
quick_gelu); SD 2.x the OpenCLIP ViT-H text tower (1024 wide, 23 layers,
gelu).  The loaders take a state dict (or a ``.pt`` or ``.safetensors``
file of one); :mod:`.encoders` builds them from a model directory.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..guidance.convert import load_state


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 23
    num_attention_heads: int = 16
    max_position_embeddings: int = 77
    hidden_act: str = "gelu"          # "quick_gelu" for SD 1.x
    layer_norm_eps: float = 1e-5


# stabilityai/stable-diffusion-2-1(-base)/text_encoder/config.json
SD21_TEXT = CLIPTextConfig()
# openai/clip-vit-large-patch14 (SD 1.x)
SD15_TEXT = CLIPTextConfig(hidden_size=768, intermediate_size=3072,
                           num_hidden_layers=12, num_attention_heads=12,
                           hidden_act="quick_gelu")
TINY_TEXT = CLIPTextConfig(vocab_size=128, hidden_size=32,
                           intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=2,
                           max_position_embeddings=16)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu(x)
    raise ValueError(name)


class CLIPAttention(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x, mask=None):
        """x [B, L, D]; ``mask`` added to the logits (the causal -inf
        triangle of the text tower; None for vision)."""
        B, L, D = x.shape
        H = self.heads
        hd = D // H
        q = (self.q_proj(x) * hd ** -0.5).reshape(B, L, H, hd)
        k = self.k_proj(x).reshape(B, L, H, hd)
        v = self.v_proj(x).reshape(B, L, H, hd)
        logits = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1))
        if mask is not None:
            logits = logits + mask
        attn = torch.softmax(logits.float(), dim=-1)
        out = torch.matmul(attn.to(v.dtype), v.transpose(1, 2))
        return self.out_proj(out.transpose(1, 2).reshape(B, L, D))


class CLIPMLP(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.act = cfg.hidden_act
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(_act(self.act, self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x, mask=None):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    """The pre-LN transformer trunk of both CLIP towers."""

    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))

    def forward(self, x, mask=None):
        for layer in self.layers:
            x = layer(x, mask)
        return x


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)

    def forward(self, ids):
        pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
        return self.token_embedding(ids) + self.position_embedding(pos)


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)

    def forward(self, ids):
        x = self.embeddings(ids)
        L = ids.shape[1]
        mask = torch.triu(torch.full((L, L), float("-inf"),
                                     device=ids.device), diagonal=1)
        return self.final_layer_norm(self.encoder(x, mask[None, None]))


class CLIPTextModel(nn.Module):
    """``last_hidden_state`` [B, L, D] of token ids [B, L]: what SD's
    prompt encoding takes."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = CLIPTextTransformer(cfg)

    def forward(self, ids):
        return self.text_model(ids)


class CLIPTextModelWithProjection(nn.Module):
    """The projected pooled embedding [B, projection_dim]: the hidden
    state at the end-of-text token (the highest id), through
    ``text_projection`` (the text vector that conditions Point-E's
    base40M-textvec)."""

    def __init__(self, cfg: CLIPTextConfig, projection_dim: int = 768):
        super().__init__()
        self.cfg = cfg
        self.text_model = CLIPTextTransformer(cfg)
        self.text_projection = nn.Linear(cfg.hidden_size, projection_dim,
                                         bias=False)

    def forward(self, ids):
        h = self.text_model(ids)
        pooled = h[torch.arange(ids.shape[0], device=ids.device),
                   torch.argmax(ids, dim=-1)]
        return self.text_projection(pooled)


def _frozen(module: nn.Module, state, device) -> nn.Module:
    load_state(module, state, lambda k: "position_ids" in k)
    return module.requires_grad_(False).eval().to(device)


def load_clip_text(state_dict, cfg: CLIPTextConfig,
                   device="cuda") -> CLIPTextModel:
    """A frozen :class:`CLIPTextModel` on ``device`` from a transformers
    ``CLIPTextModel`` state dict (or a ``.pt`` file of one)."""
    return _frozen(CLIPTextModel(cfg), state_dict, device)


def load_clip_textvec(state_dict, cfg: CLIPTextConfig,
                      projection_dim: int = 768, device="cuda"
                      ) -> CLIPTextModelWithProjection:
    """A frozen :class:`CLIPTextModelWithProjection` on ``device`` from its
    transformers state dict (or a ``.pt`` file of one)."""
    return _frozen(CLIPTextModelWithProjection(cfg, projection_dim),
                   state_dict, device)
