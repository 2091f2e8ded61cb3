"""The share of the timed window in which no operation ran on the device
(busy time a step from the trace), in %."""

from benchmark.harness.readers import idle_share


def read(ctx):
    return idle_share(ctx)
