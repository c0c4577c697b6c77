"""Self-attention cores of a UNet whose Transformer2Ds stack several
transformer blocks (SDXL's ``transformer_layers_per_block``), and their
least time: :func:`.readers.attn_sites` counts one core a Transformer2D,
which holds for SD's single blocks only."""

from __future__ import annotations

from typing import Dict, Optional

from .peaks import attn_fwd_bound_s


def attn_sites(model: Dict):
    """(heads, head dim, tokens, self-attention cores a pass) of every
    level with transformer stacks, the mid block's (at the last level's
    width, tokens and depth) last."""
    u = model["unet"]
    side = int(u["sample_size"])
    n = u["layers_per_block"]
    heads = u["attention_head_dim"]
    chs = u["block_out_channels"]
    depth = u.get("transformer_layers_per_block", 1)
    depth = [depth] * len(chs) if isinstance(depth, int) else depth
    out = []
    for lvl, ch in enumerate(chs):
        stacks = ((n if u["down_block_types"][lvl].startswith("CrossAttn")
                   else 0)
                  + (n + 1 if u["up_block_types"][-1 - lvl].startswith(
                      "CrossAttn") else 0))
        if stacks:
            out.append((heads[lvl], ch // heads[lvl], (side >> lvl) ** 2,
                        stacks * depth[lvl]))
    last = len(chs) - 1
    out.append((heads[last], chs[last] // heads[last], (side >> last) ** 2,
                depth[last]))
    return out


def attn_bound_s(model: Dict, traffic: Dict) -> float:
    """The least time a step of every self-attention core's forward, at
    the batch of each UNet pass (the frozen passes of SDS)."""
    dt = traffic["precision"]["unet"]
    return sum(count * attn_fwd_bound_s(p["batch"], L, H, D, dt)
               for H, D, L, count in attn_sites(model)
               for p in traffic["unet_passes"])


def attn_roofline_pct(ctx: Dict) -> Optional[float]:
    """The self-attention cores' least time over the device time of the
    ops launched inside the ``attn`` tag's spans."""
    dev = ctx["trace"].get("tag_s", {}).get("attn", 0.0)
    bound = attn_bound_s(ctx["model"], ctx["traffic"])
    if dev <= 0.0 or bound <= 0.0:
        return None
    return 100.0 * bound * ctx["traced_steps"] / dev
