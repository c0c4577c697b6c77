"""SDXL base 1.0 in plain PyTorch: the UNet (UNet2DConditionModel with
``transformer_layers_per_block`` and ``addition_embed_type="text_time"``),
the VAE at the configuration's scaling, and gsgen's SDS step on them.

Built on :mod:`.nets` and :mod:`.step` (the SD reference), from a diffusers
``config.json``'s keys, with diffusers' state-dict names:

* every Transformer2D of a level stacks ``transformer_layers_per_block``
  TransformerBlocks (``transformer_blocks.0`` ...), the mid block the last
  level's count, the up path the list reversed;
* the text-time embedding: each of the six time ids through a sinusoid of
  ``addition_time_embed_dim`` (cos first, as ``flip_sin_to_cos``), flattened
  after the pooled text embedding and mapped by ``add_embedding`` (a
  TimestepEmbedding), added to the time embedding;
* the time ids are (S, S, 0, 0, S, S) for a square image of side S:
  original size, crop corner, target size.

Departures from diffusers: attention is the textbook softmax with fp32
scores and no memory-efficient or flash path; no dropout, no gradient
checkpointing of the UNet, no ``upcast_attention`` or ``force_upcast``
switch (the reference is fp32 throughout); the VAE encodes one view at a
time under activation checkpointing (:class:`PerViewVAE`), so that its
fp32 backward at 1024^2 (a 16,384-token mid-block attention) fits on one
card beside the UNet; the values are a batched encode's, up to the order
of summation.  Only SDS: no LoRA, no camera class embedding.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .nets import (TimestepEmbedding, TransformerBlock, UNet, _heads,
                   set_precision, timestep_embedding)
from .quant import EXACT, Precision
from .step import ReferenceRun, direction_idx


def depths(cfg: Dict):
    """Transformer blocks a Transformer2D, by level."""
    d = cfg.get("transformer_layers_per_block", 1)
    return ([d] * len(cfg["block_out_channels"]) if isinstance(d, int)
            else list(d))


def time_ids(side: int, n: int, device) -> torch.Tensor:
    """[n, 6]: an uncropped square image of ``side`` pixels."""
    s = float(side)
    return torch.tensor([s, s, 0.0, 0.0, s, s],
                        device=device).expand(n, 6)


class UNetXL(UNet):
    """The SD UNet of :mod:`.nets` with stacked transformer blocks and the
    text-time embedding: NHWC sample in, NHWC eps out."""

    def __init__(self, cfg: Dict):
        super().__init__(cfg)
        chs, d = list(cfg["block_out_channels"]), depths(cfg)
        xdim, last = cfg["cross_attention_dim"], len(chs) - 1
        sites = ([(blk, i) for i, blk in enumerate(self.down_blocks)]
                 + [(self.mid_block, last)]
                 + [(blk, last - i) for i, blk in enumerate(self.up_blocks)])
        for blk, lvl in sites:
            for tr in getattr(blk, "attentions", []):
                tr.transformer_blocks = nn.ModuleList(
                    [TransformerBlock(chs[lvl], _heads(cfg, lvl), xdim, 0)
                     for _ in range(d[lvl])])
        if cfg.get("addition_embed_type") != "text_time":
            raise ValueError("SDXL's UNet has text-time conditioning")
        self.add_embedding = TimestepEmbedding(
            cfg["projection_class_embeddings_input_dim"], 4 * chs[0])

    def time_embedding_xl(self, t, text_embeds, ids):
        c = self.cfg
        flip, shift = c.get("flip_sin_to_cos", True), c.get("freq_shift", 0)
        temb = self.time_embedding(timestep_embedding(
            t, c["block_out_channels"][0], flip, shift))
        tid = timestep_embedding(ids.reshape(-1),
                                 c["addition_time_embed_dim"], flip, shift)
        add = torch.cat([text_embeds.float(),
                         tid.reshape(text_embeds.shape[0], -1)], dim=-1)
        return temb + self.add_embedding(add)

    def forward(self, sample, t, ctx, class_labels=None, lora_scale=0.0,
                text_embeds=None, time_ids=None):
        if class_labels is not None:
            raise ValueError("the SDXL reference has no class embedding")
        temb = self.time_embedding_xl(t, text_embeds, time_ids)
        h = self.conv_in(sample.permute(0, 3, 1, 2))
        skips = [h]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(h, temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, ctx, 0.0)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)
        mb = self.mid_block
        h = mb.resnets[1](mb.attentions[0](mb.resnets[0](h, temb), ctx, 0.0),
                          temb)
        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, ctx, 0.0)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        h = self.conv_out(torch.nn.functional.silu(self.conv_norm_out(h)))
        return h.permute(0, 2, 3, 1)


class PerViewVAE(nn.Module):
    """A VAE whose :meth:`encode` runs one view at a time, each under
    activation checkpointing: a backward holds one view's activations."""

    def __init__(self, vae: nn.Module):
        super().__init__()
        self.vae = vae

    def encode(self, img):
        return torch.cat([checkpoint(self.vae.encode, img[i:i + 1],
                                     use_reentrant=False)
                          for i in range(img.shape[0])])


class ReferenceRunXL(ReferenceRun):
    """:class:`.step.ReferenceRun` on SDXL: the SDS step with the pooled
    text embeddings (the bank's ``*_pooled`` entries, selected by view as
    the context is) and the time ids of the image's side.

    ReferenceRun builds the SD UNet of the configuration; every leaf of
    that one is a leaf of SDXL's under the same name and shape (the first
    block of each stack), so the run is set up on those and its UNet then
    replaced by :class:`UNetXL` holding all of the weights."""

    def __init__(self, cfg: Dict, unet_cfg: Dict, vae_cfg: Dict,
                 weights: Dict, bank: Dict, device,
                 precision: Dict[str, Precision] = None):
        precision = precision or {}
        dev = torch.device(device)
        full = {k: v.to(dev, torch.float32)
                for k, v in weights["unet"].items()}
        with torch.device("meta"):
            sd_keys = list(UNet(unet_cfg).state_dict())
        super().__init__(cfg, unet_cfg, vae_cfg,
                         {"unet": {k: full[k] for k in sd_keys},
                          "vae": weights["vae"]}, bank, device, precision)
        if self.kind != "sds":
            raise ValueError("the SDXL reference runs SDS only")
        with torch.device("meta"):
            self.unet = UNetXL(unet_cfg)
        self.unet.load_state_dict(full, strict=True, assign=True)
        self.unet.requires_grad_(False)
        set_precision(self.unet, precision.get("unet", EXACT))
        self.vae = PerViewVAE(self.vae)
        self._added = None

    def _embedding(self, elev, azim, view_dependent: bool):
        """The context, as ReferenceRun's; the pooled embeddings and time
        ids of the same batch are kept for the UNet call that follows."""
        b, B = self.bank, elev.shape[0]
        if view_dependent:
            idx = direction_idx(
                elev, azim, float(self.p.get("front_threshold", 45.0)),
                float(self.p.get("back_threshold", 45.0)),
                float(self.p.get("overhead_threshold", 60.0)))
            pooled = torch.cat([b["text_vd_pooled"][idx],
                                b["uncond_vd_pooled"][idx]])
        else:
            pooled = torch.cat([b["text_pooled"].expand(B, -1),
                                b["uncond_pooled"].expand(B, -1)])
        self._added = dict(text_embeds=pooled,
                           time_ids=time_ids(self.image_size, 2 * B,
                                             self.dev))
        return super()._embedding(elev, azim, view_dependent)

    def _unet(self, train, lat, t, ctx, cam=None, lora_scale=0.0):
        return self.unet(lat, t, ctx, **self._added)
