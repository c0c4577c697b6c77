"""Device ms a step of the render (the union of its ops' spans)."""

from benchmark.readers import part_ms


def read(ctx):
    return part_ms(ctx, "render")
