"""The step's least time (UNet and VAE FLOPs at the peaks of their
precisions) over the measured time a step."""

from benchmark.readers import step_mfu_pct


def read(ctx):
    return step_mfu_pct(ctx)
