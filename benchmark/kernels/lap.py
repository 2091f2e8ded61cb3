"""The batched linear assignment of the detection loss (`csrc/lap.cu`), one
launch a training step: read the float32 cost, write the assignment. A
serial chain of augmenting steps cannot reach this bound."""

from benchmark.harness.readers import bound_s

PATTERNS = ("lap_kernel",)
COUNTER = "lap"


def launch_bounds(cfg, traffic, kind, dtype):
    if kind != "train":
        return []
    B, n = traffic["batch"], cfg["num_bounding_boxes"]
    return [bound_s(0.0, 4.0 * B * n * n + 4.0 * B * n, "float32")]
