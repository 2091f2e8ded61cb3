"""Device ms a predict call of the operations launched inside the model's
forward (a range the benchmark opens with forward hooks)."""

from benchmark.harness.cells import PLANNER
from benchmark.harness.readers import range_ms


def read(ctx):
    return range_ms(ctx, [PLANNER])
