"""Text encoders behind ``prompt.model_id`` and the CLIP text vector.

Port of the JAX package's ``prompt/encoders.py`` (the reference's
CLIPTextModel / T5EncoderModel pipelines).  A model directory in the
Hugging Face layout

    <dir>/tokenizer/...               (vocab.json + merges.txt / spiece.model
                                       or tokenizer.json)
    <dir>/text_encoder/*.safetensors  (+ config.json)

(or a directory holding the encoder and its tokenizer itself) gives an
``encode_fn(list[str]) -> np.ndarray [N, L, D]`` for
:class:`.processors.PromptProcessor`.  Tokenizing and encoding are kept
apart: ``load_*`` builds a frozen tower from the directory (its weights
through the port's own safetensors reader), which takes token ids on
``device``; :func:`tokenizer` reads the directory's tokenizer files with
the port's own reader (:mod:`.tokenizer_files`: CLIP's ``vocab.json`` +
``merges.txt``, T5's ``spiece.model``, or a ``tokenizer.json``), which
gives the ids that the JAX package's ``transformers.AutoTokenizer`` gives
and needs neither ``transformers`` nor ``tokenizers``.  T5's output is
zeroed at padded positions, as the reference's IF encoder does.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..guidance.convert import load_safetensors
from .clip import CLIPTextConfig, load_clip_text, load_clip_textvec
from .t5 import T5Config, load_t5_encoder
from .tokenizer_files import load_tokenizer


def _read_config(model_dir: str) -> dict:
    p = os.path.join(model_dir, "config.json")
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return {}


def _subdir(root: str, name: str) -> str:
    """``root/name`` where it exists, else ``root`` itself."""
    d = os.path.join(root, name)
    return d if os.path.isdir(d) else root


def tokenizer(root: str, max_length: int) -> Callable:
    """``tokenize(texts) -> (ids int64 [N, max_length], mask bool)`` from
    ``root/tokenizer`` (or ``root``), padded to ``max_length``."""
    tok = load_tokenizer(_subdir(root, "tokenizer"))
    return lambda texts: tok(texts, max_length)


def _clip_config(hf: dict, **default) -> CLIPTextConfig:
    return CLIPTextConfig(**{k: hf.get(k, v) for k, v in dict(
        vocab_size=49408, max_position_embeddings=77, **default).items()})


def load_clip_text_dir(root: str, device="cuda"):
    """The frozen CLIP text tower of ``root/text_encoder`` (or ``root``):
    token ids [N, L] -> last hidden state [N, L, D]."""
    enc_dir = _subdir(root, "text_encoder")
    cfg = _clip_config(_read_config(enc_dir), hidden_size=1024,
                       intermediate_size=4096, num_hidden_layers=23,
                       num_attention_heads=16, hidden_act="gelu")
    return load_clip_text(load_safetensors(enc_dir), cfg, device=device)


def load_clip_textvec_dir(root: str, device="cuda"):
    """The frozen projected CLIP text tower (Point-E's text conditioning):
    token ids [N, L] -> [N, projection_dim]."""
    enc_dir = _subdir(root, "text_encoder")
    hf = _read_config(enc_dir)
    cfg = _clip_config(hf, hidden_size=768, intermediate_size=3072,
                       num_hidden_layers=12, num_attention_heads=12,
                       hidden_act="quick_gelu")
    return load_clip_textvec(load_safetensors(enc_dir), cfg,
                             projection_dim=hf.get("projection_dim", 768),
                             device=device)


def load_t5_dir(root: str, device="cuda"):
    """The frozen T5 encoder of ``root/text_encoder`` (or ``root``)."""
    enc_dir = _subdir(root, "text_encoder")
    hf = _read_config(enc_dir)
    cfg = T5Config(**{k: hf.get(k, getattr(T5Config, k)) for k in (
        "vocab_size", "d_model", "d_kv", "d_ff", "num_layers", "num_heads")})
    return load_t5_encoder(load_safetensors(enc_dir), cfg, device=device)


@torch.no_grad()
def encode_ids(tower, ids, mask=None) -> np.ndarray:
    """A tower's output for token ids (numpy or tensor) as a float32 numpy
    array; with ``mask`` (T5) the tower attends only to unmasked keys and
    its output is zeroed at padded positions."""
    dev = next(tower.parameters()).device
    ids = torch.as_tensor(ids, device=dev).long()
    if mask is None:
        return tower(ids).float().cpu().numpy()
    mask = torch.as_tensor(mask, device=dev).bool()
    out = tower(ids, attention_mask=mask) * mask[..., None]
    return out.float().cpu().numpy()


def _clip_fn(tower, root: str, max_length: int) -> Callable:
    tokenize = tokenizer(root, min(max_length,
                                   tower.cfg.max_position_embeddings))
    return lambda texts: encode_ids(tower, tokenize(texts)[0])


def build_clip_encode_fn(root: str, max_length: int = 77,
                         device="cuda") -> Callable:
    """CLIP text pipeline of a local SD model directory (reference
    prompt/stable_diffusion_prompt.py:20-46)."""
    return _clip_fn(load_clip_text_dir(root, device), root, max_length)


def build_t5_encode_fn(root: str, max_length: int = 77,
                       device="cuda") -> Callable:
    """T5 pipeline for DeepFloyd (reference prompt/deep_floyd_prompt.py:
    18-94; IF uses max_length 77)."""
    tower = load_t5_dir(root, device)
    tokenize = tokenizer(root, max_length)
    return lambda texts: encode_ids(tower, *tokenize(texts))


def build_clip_textvec_fn(root: str, max_length: int = 77,
                          device="cuda") -> Callable:
    """Projected pooled CLIP embedding (Point-E's text conditioning,
    reference point_e/models/pretrained_clip.py:113-121): texts ->
    [N, projection_dim]."""
    return _clip_fn(load_clip_textvec_dir(root, device), root, max_length)


def encoder_kind(model_dir: str) -> str:
    """"t5" when ``text_encoder/config.json``'s first architecture names T5,
    else "clip"."""
    hf = _read_config(_subdir(model_dir, "text_encoder"))
    arch = (hf.get("architectures") or [""])[0].lower()
    return "t5" if "t5" in arch else "clip"


def build_encode_fn(model_id: str, kind: Optional[str] = None,
                    device="cuda") -> Optional[Callable]:
    """Resolve a prompt model_id to an encode_fn: ``"mock"`` or empty ->
    None (mock embeddings); a local directory -> the CLIP or T5 pipeline
    (``kind``, else from the text encoder's config)."""
    if not model_id or model_id == "mock":
        return None
    if not os.path.isdir(model_id):
        raise FileNotFoundError(
            f"prompt.model_id {model_id!r} is not a local model "
            "directory; this environment has no network egress")
    kind = kind or encoder_kind(model_id)
    return (build_t5_encode_fn if kind == "t5"
            else build_clip_encode_fn)(model_id, device=device)

