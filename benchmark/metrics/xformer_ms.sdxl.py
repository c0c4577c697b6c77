"""Device ms a step inside the UNet's transformer stacks: the union of
the ops launched inside the ``xformer`` tag's spans (every
Transformer2DModel forward)."""


def read(ctx):
    s = ctx["trace"].get("tag_s", {}).get("xformer")
    return None if not s else 1e3 * s / ctx["traced_steps"]
