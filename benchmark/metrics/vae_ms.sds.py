"""Device ms a step of the VAE encode, forward and backward (the union of
its ops' spans)."""

from benchmark.readers import part_ms


def read(ctx):
    return part_ms(ctx, "vae")
