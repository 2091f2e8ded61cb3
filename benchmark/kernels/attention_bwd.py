"""The GPT fusion's attention backward (`csrc/attention_fused.cu`: the dq
kernel then the dk/dv kernel, one wrapper launch), in training."""

from benchmark.harness.readers import bound_s
from benchmark.harness.shapes import attention_stages

PATTERNS = ("attn_bwd_",)
COUNTER = "attention_bwd"


def launch_bounds(cfg, traffic, kind, dtype):
    if kind != "train":
        return []
    B, e = traffic["batch"], 2 if dtype == "bfloat16" else 4
    out = []
    for H, T, D in attention_stages(cfg):
        mask = B * H * T * T if cfg["attn_pdrop"] > 0 else 0
        out += [bound_s(10.0 * B * H * T * T * D, e * 7.0 * B * H * T * D + mask, dtype)] * cfg["n_layer"]
    return out
