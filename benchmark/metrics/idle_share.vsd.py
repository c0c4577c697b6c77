"""The share of a step in which no op runs on the device: the profiled
stretch's device busy time a step against the untraced time a step."""

from benchmark.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
