"""The float64 train step and `entry.Kinks` of the port, on the CPU.

`entry.train_step_on(dtype=torch.float64)` at the `tests/test_train.py:tiny_config`
size is the reference that the card's float32 step is held against
(`chip_smoke.py`): it repeats bit for bit, and the float32 step lies near
it. `entry.Kinks` records, compares and imposes the sides of each ReLU,
|x| and max-pool, on a toy and on a tiny train step. Split from
`test_torch_port_train.py` so that `--dist loadfile` runs these long tests
on a worker of their own.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffusiondrive_torch.models.layers import BatchNorm2d

from test_torch_port_model import _port_config
from test_train import tiny_config

B = 2


def test_norms_and_softmax_keep_float64():
    """A float64 input keeps its statistics in float64 (the float64 witness
    of `entry.train_step_on`); a float32 or bf16 one takes them in float32."""
    from diffusiondrive_torch.models.layers import LayerNorm, softmax_f32, stat_dtype

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 3, 5, generator=g, dtype=torch.float64) + 10.0  # float32 stats: ~1e-6 off
    bn = BatchNorm2d(4, torch.float64).double().train()
    y = bn(x)
    xs = x.permute(1, 0, 2, 3).reshape(4, -1)
    want = (xs - xs.mean(1, keepdim=True)) / torch.sqrt(xs.var(1, unbiased=False, keepdim=True) + 1e-5)
    assert y.dtype == torch.float64
    torch.testing.assert_close(y.permute(1, 0, 2, 3).reshape(4, -1), want, rtol=1e-9, atol=1e-9)
    ln = LayerNorm(5, torch.float64).double()
    assert ln(x).dtype == torch.float64 and softmax_f32(x).dtype == torch.float64
    assert [stat_dtype(x.to(d)) for d in (torch.float64, torch.float32, torch.bfloat16)] == \
        [torch.float64, torch.float32, torch.float32]


def test_float64_train_step_is_the_float32_steps_reference():
    """`entry.train_step_on` at the tiny config on the CPU: the float64 step
    repeats bit for bit, and the float32 step lies within 1e-4 x max(1, |v|)
    of it on the loss terms, 1e-4 relative on every module's forward output
    and a median 1e-3 relative L2 on the gradients (ReLUs whose inputs
    float32 rounds across 0, PERF.md §6)."""
    from diffusiondrive_torch.entry import (
        build_model, comparison_batch, grad_distances, output_distances, train_step_on)

    cfg = _port_config(tiny_config())
    model = build_model(cfg, seed=0).train()
    batch, ts, noise = comparison_batch(model, cfg, B, seed=1)
    r32 = train_step_on(model, cfg, batch, ts, noise, "cpu", record=True)
    r64, again = (train_step_on(model, cfg, batch, ts, noise, "cpu", torch.float64, record=True)
                  for _ in range(2))
    assert r64["losses"] == again["losses"] and r64["losses"] != r32["losses"]
    for k, v in r64["losses"].items():
        assert abs(r32["losses"][k] - v) <= 1e-4 * max(1.0, abs(v)), k
    outs = output_distances(r32["outputs"], r64["outputs"])
    assert len(outs) > 100 and max(outs.values()) <= 1e-4, max(outs.items(), key=lambda kv: kv[1])
    grads = grad_distances(r32["grads"], r64["grads"])
    assert set(grads) == {k for k, _ in model.named_parameters()}
    assert np.median(list(grads.values())) <= 1e-3 and max(grads.values()) <= 0.1
    assert all(torch.equal(r64["grads"][k], again["grads"][k]) for k in grads)


class _KinkToy(torch.nn.Module):
    """One ReLU, one |x| and one max-pool, as the model calls them."""

    def forward(self, x):
        y = F.max_pool2d(F.relu(x), 3, stride=2, padding=1)
        return (y - 0.5).abs().sum() + x.relu().sum()


def test_kinks_record_compare_and_impose_sides():
    """`entry.Kinks` on a toy: it records each ReLU's, |x|'s and max-pool's
    input and side in call order; a second run compares against the
    record (flips counted, `near` = the reference's |x| over its max where
    a side differs); imposing makes the second run take the record's
    sides, in its value and its gradient."""
    from diffusiondrive_torch.entry import Kinks

    toy = _KinkToy()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 8, 8, generator=g, dtype=torch.float64)
    rec = Kinks()
    hooks = rec.attach(toy)
    with rec:
        want = toy(x)
    for h in hooks:
        h.remove()
    assert [(c[0], c[1]) for c in rec.calls] == [("relu", "(loss)"), ("max_pool2d", "(loss)"), ("abs", "(loss)"),
                                                ("relu", "(loss)")]
    assert torch.equal(rec.calls[0][3], x > 0)
    x2 = x.clone()
    x2[0, 0, 0, 0] = -x[0, 0, 0, 0]                # one ReLU input across the kink
    for impose in (False, True):
        xl = x2.float().requires_grad_()
        k = Kinks(rec, impose=impose)
        with k:
            got = toy(xl)
        got.backward()
        first = k.seen[0]
        assert (first["op"], first["flips"]) == ("relu", 1)
        assert first["near"] == pytest.approx(abs(x[0, 0, 0, 0].item()) / x.abs().max().item())
        assert first["err"] == pytest.approx(2 * abs(x[0, 0, 0, 0].item()) / x.abs().max().item(), rel=1e-5)
        if impose:
            assert k.summary()["flips"] >= 1 and k.summary(("abs",))["kinks"] == 1
    # a lone ReLU: imposed, its value and gradient follow the record's side exactly
    rec_relu = Kinks()
    with rec_relu:
        F.relu(x)
    xl = x2.clone().requires_grad_()
    with Kinks(rec_relu, impose=True):
        y = F.relu(xl)
    y.sum().backward()
    mask = (x > 0).double()
    assert torch.equal(y.detach(), x2 * mask) and torch.equal(xl.grad, mask)
    same = Kinks(rec, impose=True)
    with same:
        again = toy(x)
    assert torch.equal(again, want) and sum(c["flips"] for c in same.seen) == 0
    with pytest.raises(ValueError):
        Kinks(impose=True)


def test_kinks_impose_on_a_train_step():
    """`train_step_on(kinks=...)` at the tiny config: a float32 step under
    its own recorded sides gives its own losses and gradients (the
    max-pool's gather sums in another order: 1e-5); under the float64
    step's sides, its ReLU and max-pool inputs lie within 1e-4 of max
    |float64| of the float64 step's, every flip lies within that error of
    the kink, and each call is labelled with its module."""
    from diffusiondrive_torch.entry import Kinks, build_model, comparison_batch, grad_distances, train_step_on

    cfg = _port_config(tiny_config())
    model = build_model(cfg, seed=0).train()
    batch, ts, noise = comparison_batch(model, cfg, B, seed=1)
    own = Kinks()
    r32 = train_step_on(model, cfg, batch, ts, noise, "cpu", kinks=own)
    ops = [c[0] for c in own.calls]
    assert ops.count("max_pool2d") == 2 and ops.count("abs") >= 3 and ops.count("relu") > 40
    assert {c[1] for c in own.calls} >= {"backbone.image_encoder_stem", "trajectory_head.layer0", "(loss)"}
    again = train_step_on(model, cfg, batch, ts, noise, "cpu", kinks=Kinks(own, impose=True))
    assert again["losses"] == r32["losses"]
    assert max(grad_distances(again["grads"], r32["grads"]).values()) <= 1e-5
    rec64 = Kinks()
    train_step_on(model, cfg, batch, ts, noise, "cpu", torch.float64, kinks=rec64)
    same = Kinks(rec64, impose=True)
    train_step_on(model, cfg, batch, ts, noise, "cpu", kinks=same)
    where, op, err = same.summary(("relu", "max_pool2d"))["max_err"]
    assert err <= 1e-4, (where, op, err)
    assert all(c["near"] <= c["err"] for c in same.seen if c["op"] != "max_pool2d")
