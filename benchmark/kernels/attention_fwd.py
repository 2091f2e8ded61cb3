"""The GPT fusion's attention forward (`csrc/attention_fused.cu`), one launch
a layer of each stage the kernel takes; in training with the dropout's
uint8 keep mask."""

from benchmark.harness.readers import bound_s
from benchmark.harness.shapes import attention_stages

PATTERNS = ("attn_fwd_",)
COUNTER = "attention_fwd"


def launch_bounds(cfg, traffic, kind, dtype):
    B, e = traffic["batch"], 2 if dtype == "bfloat16" else 4
    out = []
    for H, T, D in attention_stages(cfg):
        mask = B * H * T * T if kind == "train" and cfg["attn_pdrop"] > 0 else 0
        out += [bound_s(4.0 * B * H * T * T * D, e * 4.0 * B * H * T * D + mask, dtype)] * cfg["n_layer"]
    return out
