"""Floating-point work of one training step, counted on the reference's
networks on the meta device (``torch.utils.flop_counter``): the UNet
passes the traffic file lists (``batch``, and ``grad``: the pass is
differentiated with respect to its LoRA and camera-embedding leaves;
``lora``: the LoRA model, conditioned on the camera) and
the VAE encode of ``batch`` views, forward and backward to the image.
The render's work is left out.  Returns FLOPs by precision."""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference.nets import UNet, VAE


def step_flops(unet_cfg: Dict, vae_cfg: Dict, traffic: Dict,
               batch: int) -> Dict:
    vsd = traffic["guidance"] == "vsd"
    prec = traffic["precision"]
    lat = int(unet_cfg.get("sample_size", 64))
    img = lat * 2 ** (len(vae_cfg["block_out_channels"]) - 1)
    C = unet_cfg["in_channels"]
    L, D = 77, unet_cfg["cross_attention_dim"]
    with torch.device("meta"):
        unet = UNet(unet_cfg, lora_rank=4 if vsd else 0,
                    class_embed_proj_dim=16 if vsd else None)
        vae = VAE(vae_cfg)
    unet.requires_grad_(False)
    vae.requires_grad_(False)
    for k, p in unet.named_parameters():
        p.requires_grad_(any("lora" in s or s == "class_embedding"
                             for s in k.split(".")))
    out: Dict[str, float] = {}

    def count(dtype, fn):
        with FlopCounterMode(display=False) as fc:
            fn()
        out[dtype] = out.get(dtype, 0.0) + float(fc.get_total_flops())

    def unet_pass(batch, grad, lora):
        kw = dict(device="meta")
        x = torch.empty(batch, lat, lat, C, **kw)
        t = torch.zeros(batch, dtype=torch.long, **kw)
        ctx = torch.empty(batch, L, D, **kw)
        cam = torch.empty(batch, 16, **kw) if lora else None
        with torch.set_grad_enabled(grad):
            eps = unet(x, t, ctx, class_labels=cam,
                       lora_scale=1.0 if lora else 0.0)
            if grad:
                eps.sum().backward()

    for p in traffic["unet_passes"]:
        count(prec["unet"], lambda p=p: unet_pass(
            p["batch"], p.get("grad", False), p.get("lora", False)))
    def vae_pass():
        x = torch.empty(batch, img, img, 3, device="meta",
                        requires_grad=True)
        vae.encode(x).sum().backward()

    count(prec["vae"], vae_pass)
    return out
