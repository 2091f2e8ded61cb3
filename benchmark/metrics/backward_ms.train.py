"""Device ms a training step of the operations launched inside the program's `backward` range."""

from benchmark.harness.readers import range_ms


def read(ctx):
    return range_ms(ctx, ["backward"])
