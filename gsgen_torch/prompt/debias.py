"""Prompt debiasing by BERT fill-mask PMI.

Port of the JAX package's ``prompt/debias.py`` (reference
prompt/prompt_processors.py:387-447, "Debiasing Scores and Prompts of 2D
Diffusion for Robust Text-to-3D Generation", arXiv:2303.15413): for each
candidate word, the view distribution P(view | prompt) that a BERT
fill-mask model predicts at a [MASK] slot is compared with and without the
word; a word whose removal leaves the distribution nearly unchanged
(PMI < 0.95) for a view is dropped from that view's prompt.

The probe is :func:`view_probs` on token ids; :func:`get_debiased_prompt`
builds it from a local BERT directory (:mod:`.bert` through the port's
safetensors reader, the WordPiece tokenizer of its ``vocab.txt`` or
``tokenizer.json`` through the port's own reader,
:mod:`.tokenizer_files`) unless a ``fill_mask`` is given.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

VIEWS = ("side", "front", "back", "overhead")
PROBE = "This image is depicting a [MASK] view of {}"


def _build_pipeline(model_dir: str, device="cuda"):
    """(tokenizer, frozen BertForMaskedLM) of a local model directory."""
    from ..guidance.convert import load_safetensors
    from .bert import BertConfig, load_bert_mlm
    from .encoders import _read_config
    from .tokenizer_files import load_tokenizer
    tok = load_tokenizer(model_dir)
    hf = _read_config(model_dir)
    cfg = BertConfig(**{k: hf.get(k, getattr(BertConfig, k)) for k in (
        "vocab_size", "hidden_size", "num_hidden_layers",
        "num_attention_heads", "intermediate_size",
        "max_position_embeddings")})
    return tok, load_bert_mlm(load_safetensors(model_dir), cfg, device=device)


@torch.no_grad()
def view_probs(model, ids, mask, mask_token_id: int,
               view_ids: Sequence[int]) -> np.ndarray:
    """[N, 4] view distribution at each row's first [MASK] token: the
    softmax over the vocabulary of ``model(ids, mask)``'s logits there, at
    the four view words' ids, renormalised."""
    dev = next(model.parameters()).device
    ids = torch.as_tensor(ids, device=dev).long()
    logits = model(ids, torch.as_tensor(mask, device=dev).bool())
    pos = torch.argmax((ids == mask_token_id).int(), dim=1)
    p = torch.softmax(logits[torch.arange(ids.shape[0], device=dev), pos]
                      .float(), dim=-1)
    p = p[:, torch.as_tensor(list(view_ids), device=dev)]
    return (p / p.sum(dim=-1, keepdim=True)).cpu().numpy()


def bert_fill_mask(model_dir: str, max_length: int = 16,
                   device="cuda") -> Callable:
    """``fill_mask(texts) -> [N, 4]`` from a local BERT directory: each
    text in :data:`PROBE`, padded / truncated to ``max_length``."""
    tok, model = _build_pipeline(model_dir, device)
    view_ids = tok.encode(" ".join(VIEWS))[1:5]

    def fill_mask(texts):
        ids, mask = tok([PROBE.format(t) for t in texts], max_length)
        return view_probs(model, ids, mask, tok.mask_token_id, view_ids)
    return fill_mask


def get_debiased_prompt(prompt: str, model_dir: str,
                        mask_ids: Optional[List[int]] = None,
                        max_length: int = 16,
                        fill_mask: Optional[Callable] = None,
                        device="cuda") -> List[str]:
    """Per-view debiased prompts [side, front, back, overhead] (reference
    prompt_processors.py:387-447).  ``fill_mask(texts) -> probs [N, 4]``
    replaces the BERT probe of ``model_dir`` (:func:`bert_fill_mask`)."""
    if fill_mask is None:
        fill_mask = bert_fill_mask(model_dir, max_length, device)
    words = prompt.split(" ")
    mask_ids = list(range(len(words))) if mask_ids is None else list(mask_ids)
    prompts = [words.copy() for _ in range(4)]

    # one batched probe: the full prompt, then each word-dropped variant
    variants = [prompt] + [" ".join(words[:i] + words[i + 1:])
                           for i in mask_ids]
    probes = fill_mask(variants)
    full_probe = probes[0]
    for j, idx in enumerate(mask_ids):
        part_probe = probes[j + 1]
        # pmi = full / lerp(part, full, 0.5)  (:433)
        pmi = full_probe / (part_probe + 0.5 * (full_probe - part_probe))
        for v in range(4):
            if pmi[v] < 0.95:
                prompts[v][idx] = ""
    return [" ".join(w for w in p if w) for p in prompts]
