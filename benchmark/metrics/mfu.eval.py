"""The eval forward's share of the bf16 peak: the reference model's forward
operations a scene at the timed rate, in %."""

from benchmark.harness.readers import mfu


def read(ctx):
    return mfu(ctx, "eval_per_scene")
