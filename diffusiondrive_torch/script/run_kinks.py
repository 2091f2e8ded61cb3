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

Example (one GPU):
    python -m diffusiondrive_torch.script.run_kinks --seeds 5 6 7 8 9 10 11
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json

import torch

from diffusiondrive_torch.entry import (
    Kinks, build_model, comparison_batch, grad_distances, gradient_limits, train_step_on)
from diffusiondrive_torch.models import resnet
from diffusiondrive_torch.models.config import TransfuserConfig
from diffusiondrive_torch.ops.conv_fused import conv3x3_train, conv3x3_train_plain

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
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("run_kinks: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(args.out, "w") if args.out else contextlib.nullcontext() as out:
        run(TransfuserConfig(), torch.device("cuda"), args.seeds, out=out)


if __name__ == "__main__":
    main()
