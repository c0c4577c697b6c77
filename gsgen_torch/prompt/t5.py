"""T5 encoder, with the transformers parameter names (DeepFloyd's text tower).

Port of the JAX package's ``prompt/t5.py`` (the reference encodes DeepFloyd
prompts with transformers' ``T5EncoderModel``, google/t5-v1_1-xxl).  Module
and parameter names are the transformers state dict's (``shared.weight``,
``encoder.block.N.layer.0.SelfAttention.q``, ...), so one state dict fills
this module and the JAX package's flax tree.  T5 v1.1 as the JAX module
writes it: RMS layer norm (no mean, no bias, eps 1e-6), unscaled attention
logits in fp32 plus a bucketed relative position bias that block 0 computes
and every block shares, an additive -1e9 on masked keys, an fp32 softmax,
and a gated-GELU (tanh) feed-forward (``wi_0`` / ``wi_1`` / ``wo``).  The
attention is a plain matmul (no fused kernel: the JAX module reaches
none).  Parameters are fp32, as the JAX ``T5Config`` leaves them.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..guidance.convert import load_state


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6


# google/t5-v1_1-xxl (DeepFloyd IF text encoder)
T5_XXL = T5Config()
TINY_T5 = T5Config(vocab_size=128, d_model=32, d_kv=8, d_ff=64,
                   num_layers=2, num_heads=4)


class T5LayerNorm(nn.Module):
    """RMS norm: no mean subtraction, no bias."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
        return (self.weight * (x * torch.rsqrt(var + self.eps))).to(
            self.weight.dtype)


def relative_position_bucket(relative_position: torch.Tensor,
                             num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """transformers ``T5Attention._relative_position_bucket``,
    bidirectional, in float32 as the JAX package computes it."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int32) * num_buckets
    n = torch.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    log_ratio = torch.tensor(math.log(max_distance / max_exact),
                             dtype=torch.float32)
    large = max_exact + (
        torch.log(n.float() / max_exact + 1e-20) / log_ratio
        * (num_buckets - max_exact)).to(torch.int32)
    large = torch.clamp(large, max=num_buckets - 1)
    return ret + torch.where(is_small, n.to(torch.int32), large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_attention_bias=False):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_relative_attention_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads)

    def compute_bias(self, L: int) -> torch.Tensor:
        """[1, H, L, L] position bias of the query-key offsets."""
        table = self.relative_attention_bias.weight
        pos = torch.arange(L, device=table.device)
        buckets = relative_position_bucket(
            pos[None, :] - pos[:, None],
            self.cfg.relative_attention_num_buckets,
            self.cfg.relative_attention_max_distance)
        return self.relative_attention_bias(buckets.long()).permute(
            2, 0, 1)[None]

    def forward(self, x, position_bias, mask=None):
        B, L, _ = x.shape
        H, hd = self.cfg.num_heads, self.cfg.d_kv
        q, k, v = (f(x).reshape(B, L, H, hd).transpose(1, 2)
                   for f in (self.q, self.k, self.v))
        # no 1/sqrt(d): T5 folds the scale into its weights
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            + position_bias
        if mask is not None:
            attn = attn + torch.where(mask[:, None, None, :], 0.0, -1e9)
        attn = torch.softmax(attn, dim=-1)
        out = torch.matmul(attn.to(v.dtype), v)
        return self.o(out.transpose(1, 2).reshape(B, L, H * hd))


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_attention_bias=False):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_relative_attention_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x, position_bias, mask=None):
        return x + self.SelfAttention(self.layer_norm(x), position_bias,
                                      mask)


class T5DenseGatedActDense(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x):
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh")
                       * self.wi_1(x))


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseGatedActDense(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_attention_bias=False):
        super().__init__()
        self.layer = nn.ModuleList([
            T5LayerSelfAttention(cfg, has_relative_attention_bias),
            T5LayerFF(cfg)])

    def forward(self, x, position_bias, mask=None):
        return self.layer[1](self.layer[0](x, position_bias, mask))


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList([T5Block(cfg, i == 0)
                                    for i in range(cfg.num_layers)])
        self.final_layer_norm = T5LayerNorm(cfg.d_model,
                                            cfg.layer_norm_epsilon)

    def forward(self, x, mask=None):
        bias = self.block[0].layer[0].SelfAttention.compute_bias(x.shape[1])
        for blk in self.block:
            x = blk(x, bias, mask)
        return self.final_layer_norm(x)


class T5EncoderModel(nn.Module):
    """Token ids [B, L] (and a bool attention mask [B, L]) ->
    ``last_hidden_state`` [B, L, d_model]."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = T5Stack(cfg)

    def forward(self, ids, attention_mask=None):
        return self.encoder(self.shared(ids), attention_mask)


def load_t5_encoder(state_dict, cfg: T5Config, device="cuda"
                    ) -> T5EncoderModel:
    """A frozen :class:`T5EncoderModel` on ``device`` from a transformers
    ``T5EncoderModel`` state dict (or a file of one), without the tied
    ``encoder.embed_tokens.weight`` alias of ``shared.weight``."""
    module = T5EncoderModel(cfg)
    load_state(module, state_dict,
               lambda k: k == "encoder.embed_tokens.weight")
    return module.requires_grad_(False).eval().to(device)
