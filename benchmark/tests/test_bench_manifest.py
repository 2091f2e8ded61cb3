"""`BENCHMARK.json` and every file it names: found by name, well formed,
and the configurations as the program runs them."""

from __future__ import annotations

import json
import re

import pytest
import torch

from benchmark.harness import manifest, program
from benchmark.harness.manifest import BENCH, ROOT, Cell, kernel_specs, load_json, load_module

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
DOC = manifest.manifest()
CELLS = [w["name"] for w in DOC["workloads"]]


def test_manifest_keys_and_names():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert DOC["paths"] == ["benchmark"] and DOC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= DOC["run_seconds"] <= 51
    names = [m["name"] for m in DOC["end_to_end"] + DOC["per_layer"]] + CELLS + [c["name"] for c in DOC["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(DOC)) < 64 * 1024


def test_end_to_end_bounds_and_cells():
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for cell in CELLS:
        reported = [m["name"] for m in DOC["end_to_end"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in reported and len(reported) >= 2


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    layers = {}
    for m in DOC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers
    for cell in CELLS:
        assert any(cell in m["workloads"] for m in DOC["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_of_a_cell_is_found_by_name(cell):
    c = Cell(cell)
    assert c.traffic["kind"] in ("train", "agent")
    assert c.limits and all(v >= 0 for v in c.limits.values())
    for name, reader in c.readers().items():
        assert callable(reader.read), name
    for k in kernel_specs():
        assert k.PATTERNS and k.COUNTER and callable(k.launch_bounds)


def test_kernel_bounds_are_counted_from_shapes():
    cfg = load_json(BENCH / "configs" / "diffusiondrive_navsim.json")["as_run"]
    traffic = load_json(BENCH / "traffic" / "train_b64.json")
    per_step = {k.COUNTER: k.launch_bounds(cfg, traffic, "train", "bfloat16") for k in kernel_specs()}
    # ResNet-34: 12 layer-1 convs, forward and input gradient; 4 stages x 2 layers of attention; one LAP
    assert (len(per_step["conv3x3"]), len(per_step["attention_fwd"]), len(per_step["attention_bwd"]),
            len(per_step["lap"]), len(per_step["stem"]), len(per_step["splat"])) == (24, 8, 8, 1, 0, 0)
    # ResNet-50's Bottleneck blocks launch no conv3x3; its stages 1-3 take the attention, 6 layers
    r50 = {**cfg, "image_architecture": "resnet50", "lidar_architecture": "resnet50"}
    assert len(load_module(BENCH / "kernels" / "conv3x3.py").launch_bounds(r50, traffic, "train", "bfloat16")) == 0
    assert len(load_module(BENCH / "kernels" / "attention_fwd.py").launch_bounds(r50, traffic, "train", "bfloat16")) == 6


class _Op:
    def __init__(self, name, ms):
        self.name, self.start, self.end = name, 0.0, ms / 1e3


class _Trace:
    def __init__(self, kernels, steps):
        self.kernels, self.steps = kernels, steps


def _roofline_ctx(kernels, launches):
    """A traced window of two training steps of the navsim cell: the LAP and
    the attention forward's files apply; the others' kernels are not there."""
    from types import SimpleNamespace

    cfg = load_json(BENCH / "configs" / "diffusiondrive_navsim.json")["as_run"]
    files = [k for k in kernel_specs() if k.COUNTER in ("lap", "attention_fwd")]
    return SimpleNamespace(trace=_Trace(kernels, 2), launches=launches, kernel_files=files, cfg=cfg,
                           traffic=load_json(BENCH / "traffic" / "train_b64.json"), kind="train",
                           cfg_dtype="bfloat16")


@pytest.mark.parametrize("drift", [None, "renamed", "launched_more", "off_the_path"])
def test_kernel_roofline_reads_nothing_when_a_kernel_drifts(drift):
    """A kernel file that applies to the cell and finds its kernels renamed,
    launched another number of times or gone leaves the metric silent,
    instead of a sum over the other kernels."""
    from benchmark.harness.readers import kernel_roofline

    lap = [_Op("lap_kernel_warp_redux", 0.1)] * 2
    attn = [_Op("attn_fwd_mma_kernel", 0.5)] * 16
    launches = {"lap": 2, "attention_fwd": 16}
    if drift == "renamed":
        attn = [_Op("attn_forward_v2", 0.5)] * 16
    elif drift == "launched_more":
        launches["attention_fwd"] = 18
    elif drift == "off_the_path":
        attn, launches["attention_fwd"] = [], 0
    value = kernel_roofline(_roofline_ctx(lap + attn, launches))
    if drift is None:
        assert 0 < value < 100
    else:
        assert value is None


def test_idle_share_is_of_the_timed_window():
    """Busy 0.2 s of device time over 2 traced steps, and the timed window
    ran 64-sample steps at 4 a second: the device idled 60% of it, whatever
    the traced window's own wall time."""
    from types import SimpleNamespace

    from benchmark.harness.readers import idle_share

    trace = SimpleNamespace(busy_s=lambda: 0.2, steps=2, window_s=9.0)
    ctx = SimpleNamespace(trace=trace, rate=256.0, traffic={"batch": 64})
    assert idle_share(ctx) == pytest.approx(60.0)


@pytest.mark.parametrize("entry", DOC["configs"], ids=lambda e: e["name"])
def test_configuration_file_is_the_configuration_as_run(entry):
    doc = load_json(ROOT / entry["file"])
    assert doc["name"] == entry["name"] and doc["source"] == entry["source"] and doc["reduced"] == entry["reduced"]
    agent = program.build_agent(doc, torch.device("cpu"))
    assert program.config_as_run(agent) == doc["as_run"]
    assert {k: list(s) for k, (s, _) in program.weight_specs(agent.model).items()} == doc["weights"]
