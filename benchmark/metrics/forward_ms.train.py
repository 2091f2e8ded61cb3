"""Device ms a training step of the operations launched inside the program's `forward` and `loss` ranges."""

from benchmark.harness.readers import range_ms


def read(ctx):
    return range_ms(ctx, ["forward", "loss"])
