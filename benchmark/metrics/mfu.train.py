"""The training step's share of the bf16 peak: the reference model's
forward and backward operations a sample at the timed rate, in %."""

from benchmark.harness.readers import mfu


def read(ctx):
    return mfu(ctx, "train_per_sample")
