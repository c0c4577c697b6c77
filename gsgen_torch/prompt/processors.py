"""Prompt processing: view-dependent embeddings, perp-neg, caching.

Port of the JAX package's ``prompt/processors.py``.  A text encoder is a
callable ``encode_fn(list[str]) -> [N, L, D]`` numpy array; without one
the deterministic :func:`mock_encode` stands in (bit-identical to the
JAX package's).  Embeddings are cached on disk keyed by
md5(model_id:prompt), in the JAX package's file format.  With
``use_prompt_debiasing`` the four view prompts come from the BERT
fill-mask debiasing of :mod:`.debias` (``fill_mask`` replaces its probe).
"""

from __future__ import annotations

import dataclasses
import hashlib
from pathlib import Path
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

# perp-neg interpolation constants (threestudio / the Perp-Neg paper)
PERP_NEG_F_SB = (1.0, 0.5, -0.606)
PERP_NEG_F_FSB = (1.0, 0.5, 0.967)
PERP_NEG_F_FS = (4.0, 0.5, -2.426)
PERP_NEG_F_SF = (4.0, 0.5, -2.426)


def shift_azimuth_deg(azimuth):
    """to (-180, 180]."""
    return (azimuth + 180.0) % 360.0 - 180.0


def shifted_expotional_decay(a, b, c, r):
    """a exp(-b r) + c (reference spelling preserved)."""
    return a * torch.exp(-b * r) + c


def direction_templates(prompt: str, front_style: bool = False,
                        overrides: Optional[dict] = None) -> List[str]:
    """The 4 view-conditioned prompts, side/front/back/overhead."""
    overrides = overrides or {}
    if front_style:
        texts = [f"side view of {prompt}", f"front view of {prompt}",
                 f"backside view of {prompt}", f"overhead view of {prompt}"]
    else:
        texts = [f"{prompt}, side view", f"{prompt}, front view",
                 f"{prompt}, back view", f"{prompt}, overhead view"]
    for i, name in enumerate(["side", "front", "back", "overhead"]):
        if overrides.get(name):
            texts[i] = overrides[name]
    return texts


def direction_idx(elevation, azimuth, front_threshold=45.0,
                  back_threshold=45.0, overhead_threshold=60.0):
    """View-direction class per sample (0 side, 1 front, 2 back, 3
    overhead); later rules win, as in the reference."""
    azi = shift_azimuth_deg(azimuth)
    idx = torch.zeros(elevation.shape, dtype=torch.long,
                      device=elevation.device)
    idx = torch.where((azi > -front_threshold) & (azi < front_threshold),
                      1, idx)
    idx = torch.where((azi > 180.0 - back_threshold)
                      | (azi < -180.0 + back_threshold), 2, idx)
    return torch.where(elevation > overhead_threshold, 3, idx)


class PromptEmbedding(NamedTuple):
    """Precomputed embedding bank: text / uncond [L, D]; text_vd /
    uncond_vd [4, L, D] ordered side/front/back/overhead."""

    text: torch.Tensor
    uncond: torch.Tensor
    text_vd: torch.Tensor
    uncond_vd: torch.Tensor

    def get_text_embedding(self, elevation, azimuth, camera_distances,
                           use_view_dependent: bool = True):
        """[2B, L, D]: cond then uncond."""
        bs = elevation.shape[0]
        if use_view_dependent:
            idx = direction_idx(elevation, azimuth)
            cond = self.text_vd[idx]
            uncond = self.uncond_vd[idx]
        else:
            cond = self.text.expand(bs, *self.text.shape)
            uncond = self.uncond.expand(bs, *self.uncond.shape)
        return torch.cat([cond, uncond], dim=0)

    def get_text_embeddings_perp_neg(self, elevation, azimuth,
                                     camera_distances):
        """[4B, L, D] (pos, uncond, then neg0/neg1 interleaved per sample)
        and weights [B, 2]."""
        idx = direction_idx(elevation, azimuth)
        azi = shift_azimuth_deg(azimuth)
        side, front, back, overhead = self.text_vd
        uncond = self.uncond_vd[idx]
        B = idx.shape[0]

        abs_azi = torch.abs(azi)
        is_fs = abs_azi < 90.0                    # front-side interpolation
        r_fs = 1.0 - abs_azi / 90.0
        r_sb = 2.0 - abs_azi / 90.0

        def bc(emb):  # [L, D] -> [B, L, D]
            return emb.expand(B, *emb.shape)

        def col(x):
            return x[:, None, None]

        pos_interp = torch.where(
            col(is_fs), col(r_fs) * bc(front) + col(1 - r_fs) * bc(side),
            col(r_sb) * bc(side) + col(1 - r_sb) * bc(back))
        over = col(idx == 3)
        pos = torch.where(over, bc(overhead), pos_interp)
        neg0 = torch.where(over, uncond,
                           torch.where(col(is_fs), bc(front), bc(side)))
        neg1 = torch.where(over, uncond,
                           torch.where(col(is_fs), bc(side), bc(front)))

        w0 = torch.where(is_fs,
                         -shifted_expotional_decay(*PERP_NEG_F_FS, r_fs),
                         -shifted_expotional_decay(*PERP_NEG_F_SB, r_sb))
        w1 = torch.where(is_fs,
                         -shifted_expotional_decay(*PERP_NEG_F_SF, 1 - r_fs),
                         -shifted_expotional_decay(*PERP_NEG_F_FSB, r_sb))
        w = torch.stack([w0, w1], dim=-1)
        w = torch.where((idx == 3)[:, None], torch.zeros_like(w), w)

        negs = torch.stack([neg0, neg1], dim=1).reshape(-1, *neg0.shape[1:])
        return torch.cat([pos, uncond, negs], dim=0), w


@dataclasses.dataclass
class PromptProcessorConfig:
    prompt: str = "a corgi"
    negative_prompt: str = ""
    front_style: bool = False        # view_dependent_prompt_front
    use_view_dependent_prompt: bool = True
    use_perp_negative: bool = False
    front_threshold: float = 45.0
    back_threshold: float = 45.0
    overhead_threshold: float = 60.0
    use_cache: bool = True
    cache_dir: str = ".cache/text_prompt_embeddings"
    model_id: str = "mock"
    prompt_side: Optional[str] = None
    prompt_back: Optional[str] = None
    prompt_overhead: Optional[str] = None
    use_prompt_debiasing: bool = False
    debiasing_model_id: str = ""
    prompt_debiasing_mask_ids: Optional[List[int]] = None


def mock_encode(texts: Sequence[str], L: int = 77, D: int = 1024
                ) -> np.ndarray:
    """Deterministic pseudo-embeddings (distinct prompts -> distinct,
    stable vectors) for runs without text-encoder weights."""
    out = []
    for t in texts:
        seed = int(hashlib.md5(t.encode()).hexdigest()[:8], 16)
        out.append(np.random.default_rng(seed).standard_normal((L, D)))
    return np.stack(out).astype(np.float32)


class PromptProcessor:
    """Builds a PromptEmbedding bank on ``device`` from a text encoder."""

    def __init__(self, cfg: PromptProcessorConfig,
                 encode_fn: Optional[Callable] = None, device="cuda",
                 fill_mask: Optional[Callable] = None):
        self.cfg = cfg
        self.encode_fn = encode_fn or mock_encode
        if cfg.use_prompt_debiasing:
            # reference :274-281: per-view debiased base prompts; manual
            # per-view overrides are mutually exclusive with them
            if cfg.prompt_side or cfg.prompt_back or cfg.prompt_overhead:
                raise AssertionError("Do not assign prompt_side/back/"
                                     "overhead with debiasing")
            from .debias import get_debiased_prompt
            base = get_debiased_prompt(
                cfg.prompt, cfg.debiasing_model_id,
                mask_ids=cfg.prompt_debiasing_mask_ids,
                fill_mask=fill_mask, device=device)
            vd_prompts = [direction_templates(p, cfg.front_style)[i]
                          for i, p in enumerate(base)]
        else:
            overrides = {"side": cfg.prompt_side, "back": cfg.prompt_back,
                         "overhead": cfg.prompt_overhead}
            vd_prompts = direction_templates(cfg.prompt, cfg.front_style,
                                             overrides)
        texts = [cfg.prompt, cfg.negative_prompt] + vd_prompts \
            + [cfg.negative_prompt] * 4
        embs = torch.as_tensor(self._encode_cached(texts), device=device)
        self.embedding = PromptEmbedding(text=embs[0], uncond=embs[1],
                                         text_vd=embs[2:6],
                                         uncond_vd=embs[6:10])

    def _encode_cached(self, texts: List[str]) -> np.ndarray:
        if not self.cfg.use_cache:
            return self.encode_fn(texts)
        cache = Path(self.cfg.cache_dir)
        cache.mkdir(parents=True, exist_ok=True)
        out, missing, order = [None] * len(texts), [], []
        for i, t in enumerate(texts):
            key = hashlib.md5(f"{self.cfg.model_id}:{t}".encode()).hexdigest()
            f = cache / f"{key}.npy"
            if f.exists():
                out[i] = np.load(f)
            else:
                missing.append(t)
                order.append((i, f))
        if missing:
            fresh = self.encode_fn(missing)
            for (i, f), e in zip(order, fresh):
                np.save(f, e)
                out[i] = e
        return np.stack(out)

    def __call__(self) -> PromptEmbedding:
        return self.embedding
