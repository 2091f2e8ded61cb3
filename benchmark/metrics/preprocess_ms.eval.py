"""Device ms a predict call outside the model's forward: the stitch, the
resize, the BEV splat and the noise's and outputs' handling."""

from benchmark.harness.cells import PLANNER, PREDICT
from benchmark.harness.readers import range_ms


def read(ctx):
    return range_ms(ctx, [PREDICT], minus=[PLANNER])
