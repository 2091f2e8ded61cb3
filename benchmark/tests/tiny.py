"""A tiny configuration of the benchmarked model and its inputs, for the CPU
tests: every layer kind of the full model at a size a test can hold."""

from __future__ import annotations

TINY = {"camera_height": 64, "camera_width": 256, "lidar_resolution_height": 64, "lidar_resolution_width": 64,
        "img_vert_anchors": 2, "img_horz_anchors": 8, "lidar_vert_anchors": 2, "lidar_horz_anchors": 2,
        "tf_d_model": 64, "tf_d_ffn": 128, "tf_num_head": 4, "bev_pixel_height": 16, "bev_pixel_width": 32,
        "num_bounding_boxes": 12, "image_architecture": "resnet18", "lidar_architecture": "resnet18"}

SWITCHED = {"fused_conv_mode": "train", "fused_attention_mode": "on"}


def tiny_doc(agent: str = "diffusiondrive_agent", dtype: str = "float32", **overrides) -> dict:
    """A configuration document as the benchmark's configuration files hold it, at the tiny size."""
    return {"agent": agent, "agent_kwargs": {"config": {**TINY, **SWITCHED, **overrides}, "dtype": dtype}}


TRAIN_TRAFFIC = {"kind": "train", "batch": 4, "pool_batches": 4}
AGENT_TRAFFIC = {"kind": "agent", "batch": 4, "pool_batches": 2, "points": 2048, "camera_shape": [120, 900]}


def quick() -> None:
    """Give the harness the settings of a tiny run: one warm-up round that
    always counts as steady, two traced steps."""
    from benchmark.harness import cells

    cells.TRAIN = cells.AGENT = cells.Settings(warm_steps=1, warm_rounds_max=2, steady_tol=1.0, trace_steps=2)


class TinyCell:
    """A cell of the tiny configuration, as `harness.manifest.Cell` gives one."""

    def __init__(self, kind: str, limits: dict, dtype: str = "float32"):
        import time

        import torch

        from benchmark.harness import program

        traffic = dict(TRAIN_TRAFFIC if kind == "train" else AGENT_TRAFFIC)
        doc = tiny_doc(dtype=dtype)
        agent = program.build_agent(doc, torch.device("cpu"))
        doc["as_run"] = program.config_as_run(agent)
        doc["weights"] = {k: list(s) for k, (s, _) in program.weight_specs(agent.model).items()}
        doc["optimizer"] = {"lr": 6e-4, "min_lr": 1e-6, "weight_decay": 1e-4, "epochs": 100, "warmup_epochs": 3,
                            "steps_per_epoch": 1, "image_encoder_lr_mult": 0.5}
        doc["flops"] = {"train_per_sample": 1e9, "eval_per_scene": 1e9}
        self.name, self.config_doc, self.traffic, self.limits = f"tiny.{kind}", doc, traffic, limits
        self.clock0 = time.perf_counter()
