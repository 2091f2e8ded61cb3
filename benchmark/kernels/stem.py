"""The ResNet stem, conv 7x7/2 + BatchNorm + ReLU + max pool 3x3/2, in eval
(`csrc/stem_fused.cu`): one launch a branch."""

from benchmark.harness.readers import bound_s
from benchmark.harness.shapes import branches

PATTERNS = ("stem_mma_kernel", "stem_tf32x3_kernel")
COUNTER = "stem"


def launch_bounds(cfg, traffic, kind, dtype):
    if kind != "eval":
        return []
    B, e = traffic["batch"], 2 if dtype == "bfloat16" else 4
    out = []
    for _, H, W, C in branches(cfg):
        flops = 2.0 * B * (H // 2) * (W // 2) * 64 * 49 * C
        nbytes = e * (B * H * W * C + B * (H // 4) * (W // 4) * 64 + 49 * C * 64) + 2 * 64 * 4
        out.append(bound_s(flops, nbytes, dtype))
    return out
