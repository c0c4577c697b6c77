"""What the metric files under ``metrics/`` read.

Each metric is a file ``metrics/<name>.py`` with ``read(ctx)``, which
returns a number or None when the run holds nothing to read.  ``ctx``
holds, in every run, the set-up's seconds (``setup_s``), the device
memory's peak (``peak_bytes``), the timed window's steps (``steps``),
seconds (``window_s``) and time a step (``step_s``), the cell's ``model``
and ``traffic`` files; with ``--trace 1`` also the profiled stretch read
by :func:`.trace.read_events` (``trace``) over ``traced_steps`` steps
and the step's FLOPs by precision (``flops``).
"""

from __future__ import annotations

from typing import Dict, Optional

from .peaks import PEAKS, attn_bwd_bound_s, attn_fwd_bound_s


def part_ms(ctx: Dict, part: str) -> Optional[float]:
    """Device ms a step of one part (the union of its ops' spans)."""
    s = ctx["trace"]["part_s"].get(part)
    return None if not s else 1e3 * s / ctx["traced_steps"]


def idle_pct(ctx: Dict) -> float:
    """The share of an untimed step in which no op runs on the device:
    the device's busy time a step, from the profiled stretch, against
    the time a step of the untraced window (the profiler slows the host,
    not the device)."""
    t = ctx["trace"]
    return 100.0 * (1.0 - t["busy_s"] / ctx["traced_steps"]
                    / ctx["step_s"])


def attn_sites(model: Dict):
    """(heads, head dim, tokens, self-attentions a pass) of every UNet
    level with self-attention, the mid block's (one, at the last level's
    width and tokens) last."""
    u = model["unet"]
    side = int(u.get("sample_size", 64))
    n = u["layers_per_block"]
    heads = u["attention_head_dim"]
    out = []
    for lvl, ch in enumerate(u["block_out_channels"]):
        h = heads[lvl] if isinstance(heads, list) else heads
        count = ((n if u["down_block_types"][lvl].startswith("CrossAttn")
                  else 0)
                 + (n + 1 if u["up_block_types"][-1 - lvl].startswith(
                     "CrossAttn") else 0))
        if count:
            out.append((h, ch // h, (side >> lvl) ** 2, count))
    if u.get("mid_block_type", "UNetMidBlock2DCrossAttn").endswith(
            "CrossAttn"):
        last = len(u["block_out_channels"]) - 1
        h = heads[last] if isinstance(heads, list) else heads
        out.append((h, u["block_out_channels"][last] // h,
                    (side >> last) ** 2, 1))
    return out


def attn_bound_s(model: Dict, traffic: Dict) -> float:
    """The least time a step of the self-attention work at every site."""
    dt = traffic["precision"]["unet"]
    total = 0.0
    for H, D, L, count in attn_sites(model):
        for p in traffic["unet_passes"]:
            B, grad = p["batch"], p.get("grad", False)
            one = attn_fwd_bound_s(B, L, H, D, dt, with_lse=grad)
            if grad:
                one += attn_bwd_bound_s(B, L, H, D, dt)
            total += count * one
    return total


def attn_roofline_pct(ctx: Dict) -> Optional[float]:
    """The self-attentions' least time over their device time: the union
    of the ops launched inside the ``attn`` tag's spans (every
    self-attention core, forward and backward, whatever computes it)."""
    dev = ctx["trace"].get("tag_s", {}).get("attn", 0.0)
    bound = attn_bound_s(ctx["model"], ctx["traffic"])
    if dev <= 0.0 or bound <= 0.0:
        return None
    return 100.0 * bound * ctx["traced_steps"] / dev


def step_mfu_pct(ctx: Dict) -> Optional[float]:
    """The step's least time (its FLOPs by precision over the peaks)
    over the measured time a step, untraced."""
    least = sum(f / PEAKS[dt] for dt, f in ctx.get("flops", {}).items())
    if not least or not ctx.get("step_s"):
        return None
    return 100.0 * least / ctx["step_s"]
