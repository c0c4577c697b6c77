"""Device ms a step of the UNet backward (autograd through the LoRA pass)."""

from benchmark.readers import part_ms


def read(ctx):
    return part_ms(ctx, "unet_bwd")
