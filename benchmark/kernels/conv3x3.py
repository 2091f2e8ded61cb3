"""The 3x3 convolution of the ResNet's first stage (`csrc/conv3x3_fused.cu`):
in eval each block's two convs with BatchNorm folded (the second adds the
residual), in training each conv's forward and input gradient."""

from benchmark.harness.readers import bound_s
from benchmark.harness.shapes import layer1_convs

PATTERNS = ("conv3x3_mma_kernel", "conv3x3_tf32x3_kernel")
COUNTER = "conv3x3"


def launch_bounds(cfg, traffic, kind, dtype):
    B, e = traffic["batch"], 2 if dtype == "bfloat16" else 4
    out = []
    for H, W, blocks in layer1_convs(cfg):
        flops = 2.0 * B * H * W * 64 * 576
        for _ in range(blocks):
            if kind == "train":     # forward and input gradient of each conv: read x, write y, the weight
                out += [bound_s(flops, e * (2.0 * B * H * W * 64 + 576 * 64), dtype)] * 4
            else:                   # two convs, the second with the residual; the folded BN affine
                for res in (0, 1):
                    out.append(bound_s(flops, e * (B * H * W * 64 * (2 + res) + 576 * 64) + 2 * 64 * 4, dtype))
    return out
