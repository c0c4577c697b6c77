"""The UNet self-attention cores' least time, every block of every
transformer stack counted, over the device time of the ops launched
inside the self-attention cores' spans."""

from benchmark.stacks import attn_roofline_pct


def read(ctx):
    return attn_roofline_pct(ctx)
