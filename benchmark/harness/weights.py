"""Seeded weights, made on the device in a few large draws.

The benchmark makes the weights itself, so that the reference reads the
same values as the program and nothing the program made. The rule is the
published Transfuser/DiffusionDrive initialisation where it has one (the
GPT fusion's linear layers N(0, 0.02); embeddings N(0, 1)), LeCun normal
N(0, 1/fan_in) for every other convolution and linear layer, norms at 1 and
0, biases 0, but the last BatchNorm scale of each residual branch at 0.2
(torchvision's `zero_init_residual` sets it to 0): with 1 the random
network is chaotic in train mode, where bf16 rounding alone moved the
ResNet-50 training outputs by 30-75% (L2), so no comparison could tell
bf16 from a lower precision. BatchNorm running statistics are drawn too
(mean N(0, 0.3), variance U(0.7, 1.5)), so that the eval forward does not
see the identity.
The plan anchors are the benchmark's own file of NAVSIM's 20 k-means
anchors, cut to the configuration's poses.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

ANCHORS = Path(__file__).resolve().parent.parent / "configs" / "plan_anchors_20x8.npy"


def seed_for(seed: int, *tags: int) -> int:
    """A 63-bit seed for a stream of draws, from the run's seed and tags."""
    return int(np.random.SeedSequence([seed, *tags]).generate_state(1, np.uint64)[0] >> np.uint64(1))


RESIDUAL_SCALE = 0.2


def residual_scale(name: str, names) -> bool:
    """Whether `name` is the scale of a residual branch's last BatchNorm
    (`bn3` of a bottleneck block, `bn2` of a basic one)."""
    if ".block" not in name or not name.endswith((".bn2.weight", ".bn3.weight")):
        return False
    return name.endswith(".bn3.weight") or name[: -len("bn2.weight")] + "bn3.weight" not in names


def _rule(name: str, shape: Tuple[int, ...], names) -> Tuple[str, float, float]:
    """(kind, a, b) of the draw of weight `name`: ("normal", mean, std),
    ("uniform", low, high) or ("fill", value, 0)."""
    leaf = name.rsplit(".", 1)[-1]
    if residual_scale(name, names):
        return "fill", RESIDUAL_SCALE, 0.0
    if leaf == "running_mean":
        return "normal", 0.0, 0.3
    if leaf == "running_var":
        return "uniform", 0.7, 1.5
    if leaf == "pos_emb":
        return "normal", 0.0, 0.02
    if leaf in ("keyval_embedding", "query_embedding"):
        return "normal", 0.0, 1.0
    if leaf == "bias" or leaf == "num_batches_tracked":
        return "fill", 0.0, 0.0
    if leaf == "weight" and len(shape) == 1:       # LayerNorm, BatchNorm, GroupNorm scale
        return "fill", 1.0, 0.0
    if ".fusion" in name and (".attn." in name or ".mlp_fc" in name):
        return "normal", 0.0, 0.02
    return "normal", 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))


def make_weights(specs: Mapping[str, Tuple[Tuple[int, ...], torch.dtype]], seed: int, num_poses: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """Every entry of a `state_dict` with these (shape, dtype) `specs`, drawn
    from `seed` on `device`: one normal and one uniform draw for all."""
    rules = {k: _rule(k, tuple(s), specs) for k, (s, _) in specs.items() if not k.endswith("plan_anchor")}
    counts = {kind: sum(math.prod(specs[k][0]) for k, r in rules.items() if r[0] == kind)
              for kind in ("normal", "uniform")}
    gen = torch.Generator(device=device).manual_seed(seed_for(seed, 1))
    pools = {"normal": torch.randn(counts["normal"], generator=gen, device=device),
             "uniform": torch.rand(counts["uniform"], generator=gen, device=device)}
    used = {"normal": 0, "uniform": 0}
    out: Dict[str, torch.Tensor] = {}
    for k, (shape, dtype) in specs.items():
        if k.endswith("plan_anchor"):
            out[k] = torch.from_numpy(np.load(ANCHORS)[:, :num_poses].astype(np.float32)).to(device)
            continue
        kind, a, b = rules[k]
        n = math.prod(shape)
        if kind == "fill":
            out[k] = torch.full(tuple(shape), a, dtype=dtype, device=device)
            continue
        x = pools[kind][used[kind]:used[kind] + n].view(tuple(shape))
        used[kind] += n
        out[k] = (x * b + a if kind == "normal" else a + (b - a) * x).to(dtype)
    return out
