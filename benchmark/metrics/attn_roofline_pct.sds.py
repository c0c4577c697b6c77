"""The UNet self-attentions' least time, at every site, over the device
time of the ops launched inside the self-attention cores' spans."""

from benchmark.readers import attn_roofline_pct


def read(ctx):
    return attn_roofline_pct(ctx)
