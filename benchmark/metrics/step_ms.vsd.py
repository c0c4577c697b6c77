"""The timed window's wall time over the VSD steps completed in it."""


def read(ctx):
    return 1e3 * ctx["step_s"]
