"""Process start to the timed window's first step."""


def read(ctx):
    return ctx["setup_s"]
