"""Device ms a step of the UNet forward, every call (the union of its ops'
spans)."""

from benchmark.readers import part_ms


def read(ctx):
    return part_ms(ctx, "unet_fwd")
