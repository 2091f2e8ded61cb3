"""The hand-written kernels' wrappers and their plain versions."""


def kernel_counters() -> dict:
    """The hand-written kernels' wrappers by short name; each counts the
    launches of its kernel in `launches`."""
    from diffusiondrive_torch.ops.attention_fused import fused_attention, fused_attention_bwd
    from diffusiondrive_torch.ops.conv_fused import fused_conv3x3
    from diffusiondrive_torch.ops.hungarian import batched_linear_sum_assignment
    from diffusiondrive_torch.ops.lidar_splat import histogram2d
    from diffusiondrive_torch.ops.stem_fused import fused_stem

    return {"lap": batched_linear_sum_assignment, "stem": fused_stem, "conv3x3": fused_conv3x3,
            "attention_fwd": fused_attention, "attention_bwd": fused_attention_bwd, "splat": histogram2d}
