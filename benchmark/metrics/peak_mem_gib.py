"""The device allocator's peak over the checked steps, the warm-up and
the window, in GiB."""


def read(ctx):
    return ctx["peak_bytes"] / float(1 << 30)
