"""The hand-written kernels' bound times (from the cell's shapes) over their device times, in %."""

from benchmark.harness.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx)
