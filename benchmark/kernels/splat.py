"""The lidar BEV histogram (`csrc/lidar_splat.cu`), one launch a predict
call: read two int32 bin indices a point, write the float32 histogram."""

from benchmark.harness.readers import bound_s

PATTERNS = ("splat_kernel",)
COUNTER = "splat"


def launch_bounds(cfg, traffic, kind, dtype):
    if kind != "eval":
        return []
    B, N, bins = traffic["batch"], traffic["points"], cfg["lidar_resolution_width"]
    return [bound_s(0.0, 8.0 * B * N + 4.0 * B * bins * bins, "float32")]
