"""Planner-forward, agent-forward or train-step profile on the card: where the time goes.

Builds the full-width bf16 planner (`entry.py`, seeded random weights) or,
with `--agent`, the raw-sensor agent (`entry.agent_entry`: the camera stitch
and the lidar BEV splat on the device, then the planner) fed a batch of raw
features already on the card; runs 3 warm-up forwards, then `FORWARDS`
forwards under `torch.profiler`, and prints JSON lines: host wall ms per forward, device busy ms per forward (the union of
kernel intervals) and the device's idle share, kernel launches and
host-to-device copies per forward; for each model component (module paths
up to depth `DEPTH`, inclusive of their children) its device busy ms, kernel
launches and host ms per forward; and the `TOP` kernels by device time.
The range hooks and the profiler add host time, so the wall time here is
above an unprofiled forward's. With `--train` it profiles the bf16 training
step instead (`training/train.py:train_step` on a seeded batch already on
the card, AdamW at the default config): one "forward" is one step, and the
components are the step's own ranges "forward", "loss", "lap" (inside
"loss"), "backward" and "optimizer"; then it profiles the same step with
both kernel switches on (`fused_conv_mode="train"`,
`fused_attention_mode="on"`, path "train_fused"), whose components add the
fused attention's forward and backward kernels, the conv3x3 kernel's
forward and input-gradient launches (the first and second 12 of each
step's 24, in stream order) and "conv3x3_train_grad_copy" (the gradient
copied to channels_last, where autograd hands one over in another layout).
Needs a CUDA device; there is no CPU fallback.

Example (one GPU):
    python -m diffusiondrive_torch.script.run_profile --batch 16 --trace trace.json
    python -m diffusiondrive_torch.script.run_profile --batch 16 --agent
    python -m diffusiondrive_torch.script.run_profile --batch 64 --train
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

FORWARDS = 5
DEPTH = 2      # module-path depth of the components
TOP = 15       # kernels to list


def _annotate(model: torch.nn.Module, depth: int) -> list:
    """Wrap each module at path depth <= `depth` in a profiler range named by its path."""
    names = []
    for name, module in model.named_modules():
        if not name or name.count(".") >= depth:
            continue
        ranges = []

        def pre(_m, _a, name=name, ranges=ranges):
            ranges.append(record_function(name))
            ranges[-1].__enter__()

        def post(_m, _a, _o, ranges=ranges):
            ranges.pop().__exit__(None, None, None)

        module.register_forward_pre_hook(pre)
        module.register_forward_hook(post)
        names.append(name)
    return names


def _ranged(fn, name: str):
    """`fn` inside a profiler range called `name`."""
    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def _agent_forward(batch: int):
    """(forward, model, extra component names) for the raw-sensor agent path."""
    from diffusiondrive_torch.agents.diffusiondrive import agent as agent_module
    from diffusiondrive_torch.entry import agent_entry

    agent, agent_input = agent_entry(dtype=torch.bfloat16)
    feats = agent.get_feature_builders()[0].compute_features(agent_input)
    tensors = agent.features_to_device({k: np.stack([v] * batch) for k, v in feats.items()})
    extra = ["stitch_cameras", "lidar_bev"]
    for name in extra:
        setattr(agent_module, name, _ranged(getattr(agent_module, name), name))
    return (lambda: agent.predict(tensors)), agent.model, extra


def _train_step(batch: int, fused: bool = False):
    """(step, component names) for the bf16 training step, with both kernel
    switches on when `fused`."""
    from diffusiondrive_torch.device import resolve_device
    from diffusiondrive_torch.entry import build_model, example_training_sample
    from diffusiondrive_torch.models.config import TransfuserConfig
    from diffusiondrive_torch.training.dataset import collate
    from diffusiondrive_torch.training.train import OptimizerConfig, create_train_state, train_step

    switches = {"fused_conv_mode": "train", "fused_attention_mode": "on"} if fused else {}
    cfg, dev = TransfuserConfig(**switches), resolve_device(None)
    model = build_model(cfg, torch.bfloat16, seed=0).to(dev)
    state = create_train_state(model, OptimizerConfig())
    rng = np.random.default_rng(0)
    samples = collate([example_training_sample(cfg, rng) for _ in range(batch)])
    tensors = {k: torch.from_numpy(v).to(dev) for k, v in samples.items()}
    gen = torch.Generator(device=dev)
    names = ["forward", "loss", "lap", "backward", "optimizer"]
    if fused:
        names += ["attention_fwd", "attention_bwd", "conv3x3_train_fwd", "conv3x3_train_dx",
                  "conv3x3_train_grad_copy"]
    return (lambda: train_step(state, cfg, tensors, gen.manual_seed(0))), names


def _by_kernel_name(kernels, n: int, out) -> None:
    """Kernels launched through ctypes, found by their names. The LAP's
    launch sits in no op record, so no op links to it: it is added to "lap"
    and "loss". The fused attention's and conv3x3_train's launches sit inside
    their autograd Functions' op records, which `_by_launch` already counts
    in "forward" and "backward": here they get components of their own, the
    conv3x3 kernel's launches of a switched step split into its 12 forwards
    and then its 12 input gradients, in stream order."""
    def add(names, ks):
        if not ks:
            return
        for name in names:
            out[name][0] += sum(k.time_range.elapsed_us() for k in ks) / 1e3 / n
            out[name][1] += len(ks) / n

    add(("lap", "loss"), [k for k in kernels if "lap_kernel" in k.name])
    add(("attention_fwd",), [k for k in kernels if "attn_fwd_" in k.name])  # mma or CUDA-core kernel
    add(("attention_bwd",), [k for k in kernels if "attn_bwd_" in k.name])
    conv = sorted((k for k in kernels if "conv3x3_kernel" in k.name or "conv3x3_mma_kernel" in k.name),
                  key=lambda k: k.time_range.start)  # the bf16 (mma) or float32 (CUDA-core) kernel
    if conv:
        per_step = len(conv) // n
        add(("conv3x3_train_fwd",), [k for i, k in enumerate(conv) if i % per_step < per_step // 2])
        add(("conv3x3_train_dx",), [k for i, k in enumerate(conv) if i % per_step >= per_step // 2])


def _by_launch(events, names, n: int, out) -> None:
    """Device ms and launches per step of each component, by launch time: a
    kernel counts for every component whose host range was open when the op
    that launched it started, on any thread (the backward's ops run on
    autograd's own thread, outside the range's device-side span)."""
    windows = defaultdict(list)
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in names:
            windows[e.name].append((e.time_range.start, e.time_range.end))
    for e in events:
        if e.device_type != DeviceType.CPU or e.name in names or not e.kernels:
            continue
        t = e.time_range.start
        for name, spans in windows.items():
            if any(s <= t < end for s, end in spans):
                out[name][0] += sum(k.duration for k in e.kernels) / 1e3 / n
                out[name][1] += len(e.kernels) / n


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--trace", default=None, help="write a Chrome trace here")
    parser.add_argument("--agent", action="store_true",
                        help="profile the raw-sensor agent path, not the planner alone")
    parser.add_argument("--train", action="store_true",
                        help="profile the training step (forward, loss, LAP, backward, optimizer)")
    args = parser.parse_args()

    from diffusiondrive_torch.entry import entry

    if not torch.cuda.is_available():
        raise SystemExit("run_profile: no CUDA device")
    if args.train:
        for fused in (False, True):
            forward, components = _train_step(args.batch, fused)
            _profile("train_fused" if fused else "train", forward, components, args, train=True)
        return
    if args.agent:
        forward, model, extra = _agent_forward(args.batch)
    else:
        model, inputs = entry(dtype=torch.bfloat16, batch=args.batch)
        gen = torch.Generator(device=inputs["status_feature"].device)
        forward, extra = (lambda: model(**inputs, generator=gen.manual_seed(0))), []
    _profile("agent" if args.agent else "planner", forward, _annotate(model, DEPTH) + extra, args, train=False)


def _profile(path: str, forward, components, args, train: bool) -> None:
    """Warm up, profile `FORWARDS` calls of `forward`, print the JSON lines."""
    n = FORWARDS
    with contextlib.nullcontext() if train else torch.no_grad():
        for _ in range(3):
            forward()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                forward()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
    if args.trace:
        prof.export_chrome_trace(args.trace.replace(".json", f"_{path}.json") if train else args.trace)

    events = prof.events()
    names = set(components)
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    # the component ranges show on the device timeline too: they are no kernels
    kernels = [e for e in on_device if e.name not in names and not getattr(e, "is_user_annotation", False)
               and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    htod = [e for e in on_device if "htod" in e.name.lower()]
    spans = lambda evs: [(e.time_range.start, e.time_range.end) for e in evs]  # noqa: E731
    busy_ms = _busy_us(spans(kernels)) / 1e3 / n
    by_kernel = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_kernel[e.name][0] += e.time_range.elapsed_us()
        by_kernel[e.name][1] += 1
    by_component = defaultdict(lambda: [0.0, 0, 0.0])
    if train:
        _by_launch(events, names, n, by_component)
        _by_kernel_name(kernels, n, by_component)
    else:
        # a component's device time: the kernels inside its range on the device timeline
        for e in on_device:
            if e.name in names:
                inside = [k for k in kernels if e.time_range.start <= k.time_range.start < e.time_range.end]
                by_component[e.name][0] += _busy_us(spans(inside)) / 1e3 / n
                by_component[e.name][1] += len(inside) / n
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in names:
            by_component[e.name][2] += e.time_range.elapsed_us() / 1e3 / n

    print(json.dumps({"device": torch.cuda.get_device_name(0), "dtype": "bfloat16", "batch": args.batch,
                      "path": path, "forwards": n, "wall_ms_per_forward": wall_ms,
                      "device_busy_ms_per_forward": busy_ms,
                      "device_idle_share": 1.0 - busy_ms / wall_ms,
                      "kernel_launches_per_forward": len(kernels) / n,
                      "htod_copies_per_forward": len(htod) / n}))
    print(json.dumps({"components": [
        {"name": k, "device_ms": v[0], "launches": v[1], "host_ms": v[2]}
        for k, v in sorted(by_component.items(), key=lambda kv: -kv[1][0])]}))
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:TOP]
    print(json.dumps({"top_kernels": [{"name": k[:120], "ms_per_forward": v[0] / 1e3 / n,
                                        "launches_per_forward": v[1] / n} for k, v in top]}), flush=True)


if __name__ == "__main__":
    main()
