"""Where do float32 train steps part from float64 at a kink, and does the gradient gate hold on the same side?

`chip_smoke.py` holds float32 card train steps against the CPU's float64
step, per parameter (`entry.gradient_limits`), with the float64 step's side
imposed at every ReLU, |x| and max-pool (`entry.Kinks`). This prints, for
each `comparison_batch` seed, one JSON line per variant of the card float32
step: the default config, the fused attention only, `conv3x3_train` only,
both, and four splits of the layer-1 conv: `conv_exact` (forward and input
gradient computed in float64 and rounded once to float32, the most accurate
float32 the convs can give), `conv_exact_fwd` (that forward, the kernel's
input gradient), `conv_kernel_fwd_plain_dx` and `conv_plain_fwd_kernel_dx`
(the kernel for one, cuDNN for the other). For each: the worst parameter
as a multiple of the gate (above 1 fails) without and with the float64
step's sides imposed, the kinks whose side it took otherwise
(`Kinks.summary`; on stdout only the ReLUs outside the backbone, whole
with `--out`), and the largest ReLU/max-pool input error. A last line
per seed gives the error of the layer-1 conv's forward on the inputs of the
`conv` step: the kernel's and cuDNN's float32 against float64, relative L2
and max over max |float64|. Full width, B=2; needs a CUDA device, ~40 s a
seed.

With `--variant NAME` (a registry variant, `entry.VARIANTS`) it compares
instead, per seed, that variant's CPU float32 and card float32 steps with
the CPU float64 step (`--small`: at the small width of
`tests/test_torch_port_cuda.py::test_cuda_variant_forward_and_train_step`),
one JSON line each (the card's also with cuDNN off): the loss terms'
distance to float64, the gradients' relative L2 (median, p90, worst) on
their own sides and with the float64 step's sides imposed (and the losses
then), the kinks that took another side, the detection assignment (equal
to float64's on every valid target, each run's `entry.assignment_margin`
per row, and where it differs the predicted and target centres of the
targets matched otherwise), `entry.box_loss_move_bound` (the most the
box loss can move with float64's assignment) with the largest |box -
float64's box| over those boxes, and the first
module outputs, in forward order, that lie more than 1e-4 and 1e-3
(relative L2) from float64, with the five farthest.

Example (one GPU):
    python -m diffusiondrive_torch.script.run_kinks --seeds 5 6 7 8 9 10 11
    python -m diffusiondrive_torch.script.run_kinks --variant transfuser_agent --seeds 5
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json

import torch

from diffusiondrive_torch.entry import (
    VARIANTS, Kinks, assignment_margin, box_loss_move_bound, build_model, comparison_batch, grad_distances,
    gradient_limits, output_distances, train_step_on, variant_config)
from diffusiondrive_torch.models import resnet
from diffusiondrive_torch.models.config import TransfuserConfig
from diffusiondrive_torch.ops.conv_fused import conv3x3_train, conv3x3_train_plain

# the small width of tests/test_torch_port_cuda.py::test_cuda_variant_forward_and_train_step
SMALL = dict(camera_height=64, camera_width=256, lidar_resolution_height=64, lidar_resolution_width=64,
             img_vert_anchors=2, img_horz_anchors=8, lidar_vert_anchors=2, lidar_horz_anchors=2,
             bev_pixel_height=32, bev_pixel_width=64, unet_down_dims=(32, 64))

SWITCHES = {"default": {}, "attention": {"fused_attention_mode": "on"}, "conv": {"fused_conv_mode": "train"},
            "both": {"fused_attention_mode": "on", "fused_conv_mode": "train"}}


def _exact(x, w):
    return conv3x3_train_plain(x.double(), w.double()).to(x.dtype)


def _value_of(fwd, dx):
    """A conv whose value is `fwd`'s and whose gradients are `dx`'s."""
    def conv(x, w):
        y = dx(x, w)
        return y + (fwd(x.detach(), w.detach()) - y).detach()
    return conv


CONV_SPLITS = {"conv_exact": _exact, "conv_exact_fwd": _value_of(_exact, conv3x3_train),
               "conv_kernel_fwd_plain_dx": _value_of(conv3x3_train, conv3x3_train_plain),
               "conv_plain_fwd_kernel_dx": _value_of(conv3x3_train_plain, conv3x3_train)}


@contextlib.contextmanager
def _layer1_conv(fn):
    """The switched BasicBlocks' conv replaced by `fn` for the block."""
    kept = resnet.conv3x3_train
    resnet.conv3x3_train = fn
    try:
        yield
    finally:
        resnet.conv3x3_train = kept


def _worst(grads, ref, limit):
    over = {k: v / limit[k] for k, v in grad_distances(grads, ref).items()}
    k = max(over, key=over.get)
    return [k, over[k]]


def _conv_errors(calls):
    """Per layer-1 conv call of a step: kernel and cuDNN float32 against float64."""
    out = {"kernel": [], "cudnn": []}
    with torch.no_grad():
        for x, w in calls:
            want = conv3x3_train_plain(x.double(), w.double())
            top, norm = want.abs().max().item(), want.norm().item()
            for name, fn in (("kernel", conv3x3_train), ("cudnn", conv3x3_train_plain)):
                d = fn(x, w).double() - want
                out[name].append([d.norm().item() / norm, d.abs().max().item() / top])
    return {k: {"rel_l2_max": max(e[0] for e in v), "max_over_max_max": max(e[1] for e in v), "calls": len(v)}
            for k, v in out.items()}


def run(cfg: TransfuserConfig, dev: torch.device, seeds, batch_size: int = 2, out=None) -> None:
    """The JSON lines above for `cfg` on `dev`, one block per seed; whole
    to the open file `out`, shortened to stdout (`_emit`)."""
    model = build_model(cfg, torch.float32, seed=0).train()
    variants = {}
    for name, kw in SWITCHES.items():
        c = dataclasses.replace(cfg, **kw)
        m = build_model(c, torch.float32, seed=0).train()
        m.load_state_dict(model.state_dict())
        variants[name] = (m, c, None)
    variants.update({name: (*variants["conv"][:2], fn) for name, fn in CONV_SPLITS.items()})
    head = {"device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"}
    for seed in seeds:
        batch, ts, noise = comparison_batch(model, cfg, batch_size, seed=seed)
        ref_kinks = Kinks()
        ref = train_step_on(model, cfg, batch, ts, noise, "cpu", torch.float64, kinks=ref_kinks)["grads"]
        limit = gradient_limits(train_step_on(model, cfg, batch, ts, noise, "cpu", torch.float32)["grads"], ref)
        limit_same_side = gradient_limits(train_step_on(model, cfg, batch, ts, noise, "cpu", torch.float32,
                                                        kinks=Kinks(ref_kinks, impose=True))["grads"], ref)
        captured = []

        def capturing(x, w):
            captured.append((x.detach(), w.detach()))
            return conv3x3_train(x, w)

        for name, (m, c, fn) in variants.items():
            row = {}
            for impose in (False, True):
                if name == "conv":
                    fn = None if impose else capturing
                kinks = Kinks(ref_kinks, impose=impose)
                with _layer1_conv(fn) if fn is not None else contextlib.nullcontext():
                    grads = train_step_on(m, c, batch, ts, noise, dev, torch.float32, kinks=kinks)["grads"]
                row["same_side" if impose else "own_side"] = _worst(grads, ref, limit_same_side if impose else limit)
                if not impose:
                    row["kinks"] = kinks.summary()
                    row["relu_pool_max_err"] = kinks.summary(("relu", "max_pool2d"))["max_err"]
            _emit({**head, "comparison_seed": seed, "variant": name, **row}, out)
        _emit({**head, "comparison_seed": seed, "layer1_conv_fwd_vs_float64": _conv_errors(captured)}, out)


def _quantiles(values) -> dict:
    v = sorted(values)
    return {"median": v[len(v) // 2], "p90": v[int(0.9 * (len(v) - 1))], "max": v[-1]}


def _valid_matches(cols: torch.Tensor, valid: torch.Tensor) -> dict:
    """{valid target: the prediction matched to it} of one row."""
    return {int(j): i for i, j in enumerate(cols.tolist()) if valid[j]}


def run_variant(name: str, dev: torch.device, seeds, small: bool = False, out=None) -> None:
    """The `--variant` lines: `name`'s CPU and card float32 steps against
    the CPU float64 step, per `comparison_batch` seed."""
    head, cfg = variant_config(name, **(SMALL if small else {}), **(
        {"image_architecture": "resnet18", "lidar_architecture": "resnet18"}
        if small and name != "diffusiondrive_nuscenes_agent" else {}))
    model = build_model(cfg, torch.float32, seed=0, trajectory_head_type=head).train()
    head_row = {"device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu", "variant": name,
                "width": "small" if small else "full"}
    for seed in seeds:
        batch, ts, noise = comparison_batch(model, cfg, 2, seed=seed)
        valid = torch.from_numpy(batch["agent_labels"]).bool()
        ref_kinks = Kinks()
        ref = train_step_on(model, cfg, batch, ts, noise, "cpu", torch.float64, record=True, kinks=ref_kinks)
        ref_cost, ref_cols, ref_boxes = (ref["assignment"][k] for k in ("cost", "cols", "agent_states"))
        targets = torch.from_numpy(batch["agent_states"]).double()
        for label, d, cudnn in (("cpu_f32", torch.device("cpu"), True), ("card_f32", dev, True),
                                ("card_f32_no_cudnn", dev, False)):
            kinks = Kinks(ref_kinks)
            run = train_step_on(model, cfg, batch, ts, noise, d, torch.float32, cudnn=cudnn, record=True,
                                kinks=kinks)
            same_side = train_step_on(model, cfg, batch, ts, noise, d, torch.float32, cudnn=cudnn,
                                      kinks=Kinks(ref_kinks, impose=True))
            cost, cols, boxes = (run["assignment"][k] for k in ("cost", "cols", "agent_states"))
            moved = (boxes - ref_boxes).abs() * valid.double().gather(1, ref_cols.long())[:, :, None]
            otherwise = [[{"target": j, "target_xy": targets[b, j, :2].tolist(),
                           "pred": [i, boxes[b, i, :2].tolist()], "pred_f64": [i64, ref_boxes[b, i64, :2].tolist()]}
                          for j, i in _valid_matches(cols[b], valid[b]).items()
                          for i64 in [_valid_matches(ref_cols[b], valid[b])[j]] if i != i64]
                         for b in range(len(valid))]
            outs = output_distances(run["outputs"], ref["outputs"])
            first = {t: next(([k, v] for k, v in outs.items() if v > t), None) for t in (1e-4, 1e-3)}
            row = {"comparison_seed": seed, "run": label,
                   "loss_minus_f64": {k: v - ref["losses"][k] for k, v in run["losses"].items()},
                   "loss_minus_f64_same_side": {k: v - ref["losses"][k] for k, v in same_side["losses"].items()},
                   "grad_rel_l2": _quantiles(grad_distances(run["grads"], ref["grads"]).values()),
                   "grad_rel_l2_same_side": _quantiles(grad_distances(same_side["grads"], ref["grads"]).values()),
                   "assignment_equal_f64": [_valid_matches(cols[b], valid[b]) == _valid_matches(ref_cols[b], valid[b])
                                            for b in range(len(valid))],
                   "margin": [assignment_margin(cost[b], cols[b].long(), valid[b]) for b in range(len(valid))],
                   "margin_f64": [assignment_margin(ref_cost[b], ref_cols[b].long(), valid[b])
                                  for b in range(len(valid))],
                   "matched_otherwise": otherwise,
                   "box_loss_move_bound": box_loss_move_bound(run, ref, valid, cfg),
                   "box_moved_max": moved.max().item(),
                   "kinks": kinks.summary(), "first_output_over": first,
                   "farthest_outputs": sorted(outs.items(), key=lambda kv: -kv[1])[:5]}
            _emit({**head_row, **row}, out)


def _emit(row: dict, out) -> None:
    """The whole row to `out`; to stdout without the kink lists, but with
    the ReLUs outside the backbone that took another side: [where, flips,
    near]."""
    if out is not None:
        out.write(json.dumps(row) + "\n")
        out.flush()
    if "kinks" in row:
        k = row.pop("kinks")
        row.update(flips=k["flips"], head_relu_flips=[[w, n, float(f"{near:.3g}")]
                                                      for w, op, n, near in k["flips_outside_backbone"]
                                                      if op == "relu"])
    print(json.dumps(row), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seeds", type=int, nargs="+", default=[5, 10])
    parser.add_argument("--out", default=None, help="file for the whole JSON lines")
    parser.add_argument("--variant", choices=sorted(VARIANTS), default=None,
                        help="compare this registry variant's float32 steps with float64 instead")
    parser.add_argument("--small", action="store_true", help="with --variant: the CUDA test's small width")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("run_kinks: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(args.out, "w") if args.out else contextlib.nullcontext() as out:
        if args.variant:
            run_variant(args.variant, torch.device("cuda"), args.seeds, small=args.small, out=out)
        else:
            run(TransfuserConfig(), torch.device("cuda"), args.seeds, out=out)


if __name__ == "__main__":
    main()
