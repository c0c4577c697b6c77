"""K1-K4's duplicates per rendered view over the traced steps: the
program's own counters (``render.dups`` over ``render.views``); nothing
where the program has no such counters."""

from benchmark.program_trace import dups_per_view


def read(ctx):
    return dups_per_view()
