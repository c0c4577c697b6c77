"""BERT masked-LM, with the transformers parameter names (prompt debiasing).

Port of the JAX package's ``prompt/bert.py``: the fill-mask model that
debiases view-dependent prompts (:mod:`.debias`).  Module and parameter
names are transformers' ``BertForMaskedLM`` state dict's
(``bert.encoder.layer.N.attention.self.query``, ``cls.predictions.
transform.dense``, ``cls.predictions.decoder``, ...); :func:`_fix_keys`
drops what the JAX loader drops (``position_ids``, the pooler,
``cls.predictions.bias``).  Post-LN encoder layers with exact (erf) GELU,
scaled logits in fp32 plus an additive -1e9 on masked keys, a plain
matmul attention (the JAX module reaches no fused kernel).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..guidance.convert import load_state, read_state_dict


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12


BERT_BASE = BertConfig()
TINY_BERT = BertConfig(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                       num_attention_heads=2, intermediate_size=64,
                       max_position_embeddings=32)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)

    def forward(self, x, mask_bias):
        B, L, D = x.shape
        hd = D // self.heads
        q, k, v = (f(x).reshape(B, L, self.heads, hd).transpose(1, 2)
                   for f in (self.query, self.key, self.value))
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            / hd ** 0.5
        attn = torch.softmax(attn + mask_bias, dim=-1)
        out = torch.matmul(attn.to(v.dtype), v)
        return out.transpose(1, 2).reshape(B, L, D)


class BertSelfOutput(nn.Module):
    """dense, then the post-LN residual (the attention's and the
    feed-forward's output)."""

    def __init__(self, cfg: BertConfig, d_in: int):
        super().__init__()
        self.dense = nn.Linear(d_in, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, h, residual):
        return self.LayerNorm(self.dense(h) + residual)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertSelfOutput(cfg, cfg.hidden_size)

    def forward(self, x, mask_bias):
        return self.output(self.self(x, mask_bias), x)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x):
        return F.gelu(self.dense(x))


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertSelfOutput(cfg, cfg.intermediate_size)

    def forward(self, x, mask_bias):
        x = self.attention(x, mask_bias)
        return self.output(self.intermediate(x), x)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, ids):
        pos = torch.arange(ids.shape[1], device=ids.device)[None]
        return self.LayerNorm(self.word_embeddings(ids)
                              + self.position_embeddings(pos)
                              + self.token_type_embeddings(
                                  torch.zeros_like(ids)))


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList([BertLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers)])

    def forward(self, x, mask_bias):
        for lyr in self.layer:
            x = lyr(x, mask_bias)
        return x


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg)

    def forward(self, ids, attention_mask):
        bias = torch.where(attention_mask[:, None, None, :], 0.0, -1e9)
        return self.encoder(self.embeddings(ids), bias)


class BertPredictionHeadTransform(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x):
        return self.LayerNorm(F.gelu(self.dense(x)))


class BertLMPredictionHead(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.transform = BertPredictionHeadTransform(cfg)
        self.decoder = nn.Linear(cfg.hidden_size, cfg.vocab_size)

    def forward(self, x):
        return self.decoder(self.transform(x))


class BertOnlyMLMHead(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.predictions = BertLMPredictionHead(cfg)

    def forward(self, x):
        return self.predictions(x)


class BertForMaskedLM(nn.Module):
    """Token ids [B, L] and a bool attention mask [B, L] -> MLM logits
    [B, L, vocab]."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(cfg)
        self.cls = BertOnlyMLMHead(cfg)

    def forward(self, ids, attention_mask):
        return self.cls(self.bert(ids, attention_mask))


def _fix_keys(state):
    """A transformers ``BertForMaskedLM`` state dict without the keys the
    JAX loader drops: ``position_ids``, ``cls.predictions.bias`` (the
    decoder's bias carries the same values) and the pooler (unused by
    the MLM head)."""
    return {k: v for k, v in state.items()
            if "position_ids" not in k and k != "cls.predictions.bias"
            and ".pooler." not in k}


def load_bert_mlm(state_dict, cfg: BertConfig = BERT_BASE, device="cuda"
                  ) -> BertForMaskedLM:
    """A frozen :class:`BertForMaskedLM` on ``device`` from its transformers
    state dict (or a file of one).  A checkpoint without the decoder's
    weight (tied) takes the word embedding matrix; one without its bias
    takes zeros, as the JAX loader does."""
    state = _fix_keys(read_state_dict(state_dict))
    if "cls.predictions.decoder.weight" not in state:
        state["cls.predictions.decoder.weight"] = \
            state["bert.embeddings.word_embeddings.weight"]
    if "cls.predictions.decoder.bias" not in state:
        state["cls.predictions.decoder.bias"] = torch.zeros(cfg.vocab_size)
    module = BertForMaskedLM(cfg)
    load_state(module, state)
    return module.requires_grad_(False).eval().to(device)
