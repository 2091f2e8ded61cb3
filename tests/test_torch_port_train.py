"""Port parity of the training path against the JAX package, on the CPU.

One module-scoped fixture runs the JAX train step once at the
`tests/test_train.py:tiny_config` size (float32): the training forward, the
loss, the gradients, the first AdamW update and the new BN statistics, in
one jitted program. Its dropouts and its two diffusion draws are fixed
inside a monkeypatch around that jit only (dropout returns its input;
`jax.random.randint` and `jax.random.normal` return seeded arrays); the
port gets the same draws through `timesteps=` / `diffusion_noise=` and has
its dropout switched off. Gradient trees cross over through
`utils/port_jax.py:jax_params_to_named`.

Tolerances: the port and JAX sum in other orders, so float32 results agree
to ~1e-6 relative per op; through the whole model and its backward that
grows to ~1e-5..1e-4 relative, hence 1e-3 for the forward outputs (the
planner test's bound), 1e-4 relative for the loss terms and 1e-3 of each
parameter's largest gradient for the gradients (plus 1e-6 of the largest
gradient of all, for parameters whose gradient is zero but for rounding,
such as the attention keys' biases). The first AdamW update is
lr*g/(|g| + eps), about lr*sign(g): where the two gradients have the same
sign the updated parameters are held to 1e-5 relative plus twice what the
gradients' difference moves that quotient; where the signs differ (measured:
2449 of 40195727 elements, nearly all in the attention keys' biases) either
side moves by lr*mult, so those are held to 2*lr*mult, and they must be at
most 1% of any parameter whose gradient is not zero but for rounding.
"""

import json
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment as scipy_lsa

from diffusiondrive_tpu.models.transfuser_model import DiffusionDriveModel as JModel
from diffusiondrive_tpu.training import losses as jlosses
from diffusiondrive_tpu.training.scheduler import warmup_cos_lr as j_warmup_cos_lr
from diffusiondrive_tpu.training.train import OptimizerConfig as JOptimizerConfig
from diffusiondrive_tpu.training.train import _param_labels, build_optimizer as j_build_optimizer

from diffusiondrive_torch.entry import place_targets_at_predictions
from diffusiondrive_torch.models.layers import BatchNorm2d, disable_dropout
from diffusiondrive_torch.models.transfuser_model import DiffusionDriveModel
from diffusiondrive_torch.ops.ddim import DDIMScheduler
from diffusiondrive_torch.ops.hungarian import linear_sum_assignment_plain
from diffusiondrive_torch.training import losses as plosses
from diffusiondrive_torch.training.scheduler import warmup_cos_lr
from diffusiondrive_torch.training.train import (
    OptimizerConfig,
    build_optimizer,
    create_train_state,
    train_step,
)
from diffusiondrive_torch.utils.port_jax import jax_params_to_named, load_jax_variables

from test_torch_port_model import _port_config
from test_train import make_batch, tiny_config

B = 2
LR0 = 6e-4 / 3  # WarmupCosLR at step 0 with the default OptimizerConfig (3 warm-up epochs)


def assignment_margin(cost: np.ndarray, valid: np.ndarray) -> float:
    """How much more the best assignment costs once any one of its edges to a
    valid target is forbidden (0 when the optimum is not unique)."""
    r, c = scipy_lsa(cost)
    best = cost[r, c].sum(dtype=np.float64)
    margin = np.inf
    for i, j in zip(r, c):
        if valid[j]:
            forced = cost.astype(np.float64).copy()
            forced[i, j] = 1e12
            r2, c2 = scipy_lsa(forced)
            margin = min(margin, forced[r2, c2].sum() - best)
    return float(margin)


def _draws(jcfg, seed=11):
    rng = np.random.default_rng(seed)
    timesteps = rng.integers(0, jcfg.diffusion_train_max_t, B).astype(np.int32)
    noise = rng.normal(size=(B, jcfg.ego_fut_mode, jcfg.num_poses, 2)).astype(np.float32)
    return timesteps, noise


@pytest.fixture(scope="module")
def jax_step():
    """Variables, batch, draws and the JAX train step's results (numpy)."""
    jcfg = tiny_config()
    jmodel = JModel(jcfg)
    batch = make_batch(B, seed=5)
    rng = np.random.default_rng(7)
    variables = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
                                     batch["camera_feature"], batch["lidar_feature"], batch["status_feature"])
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(0, 0.3, a.shape) if p[-1].key == "mean"
                      else rng.uniform(0.7, 1.5, a.shape)).astype(np.float32), variables["batch_stats"])
    timesteps, noise = _draws(jcfg)
    # one optimal detection assignment (`place_targets_at_predictions`; the
    # port's forward at these weights and draws gives the predicted boxes);
    # `test_train_step_losses_match_jax` checks the margin
    model = load_jax_variables(DiffusionDriveModel(_port_config(jcfg)), variables).train()
    disable_dropout(model)
    with torch.no_grad():
        pred = model(*(torch.from_numpy(batch[k]) for k in ("camera_feature", "lidar_feature", "status_feature")),
                     timesteps=torch.from_numpy(timesteps).long(),
                     diffusion_noise=torch.from_numpy(noise))["agent_states"].numpy()
    batch = place_targets_at_predictions(batch, pred, rng)
    targets = {k: jnp.asarray(batch[k]) for k in ("trajectory", "agent_states", "agent_labels",
                                                  "bev_semantic_map")}
    tx = j_build_optimizer(JOptimizerConfig(), variables["params"])

    def step(params, batch_stats, constants, inputs):
        # the body of `train.make_loss_fn` (forward with train=True and mutable
        # batch stats, then `transfuser_loss`), with the outputs kept as well
        def loss_fn(p):
            outputs, mutated = jmodel.apply(
                {"params": p, "batch_stats": batch_stats, "constants": constants},
                inputs["camera_feature"], inputs["lidar_feature"], inputs["status_feature"],
                targets=targets, train=True,
                rngs={"diffusion": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)},
                mutable=["batch_stats"])
            loss_dict = jlosses.transfuser_loss(targets, outputs, jcfg)
            return loss_dict["loss"], (loss_dict, mutated["batch_stats"], outputs)

        grads, (loss_dict, new_bs, outputs) = jax.grad(loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return grads, loss_dict, new_bs, outputs, optax.apply_updates(params, updates)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, inputs, *a, **k: inputs)
        mp.setattr(jax.random, "randint", lambda *a, **k: jnp.asarray(timesteps))
        mp.setattr(jax.random, "normal", lambda *a, **k: jnp.asarray(noise))
        inputs = {k: jnp.asarray(batch[k]) for k in ("camera_feature", "lidar_feature", "status_feature")}
        out = jax.jit(step)(variables["params"], variables["batch_stats"], variables["constants"], inputs)
    grads, loss_dict, new_bs, outputs, new_params = jax.tree_util.tree_map(np.asarray, out)
    return dict(jcfg=jcfg, variables=variables, batch=batch, timesteps=timesteps, noise=noise,
                grads=grads, loss_dict=loss_dict, new_bs=new_bs, outputs=outputs, new_params=new_params)


def _port_model(js):
    model = load_jax_variables(DiffusionDriveModel(_port_config(js["jcfg"])), js["variables"]).train()
    disable_dropout(model)
    return model


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def port_step(jax_step):
    """The port's train step on the same weights, batch and draws."""
    js = jax_step
    model = _port_model(js)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = create_train_state(model, OptimizerConfig())
    loss_dict = train_step(state, model.config, _tensors(js["batch"]),
                           timesteps=torch.from_numpy(js["timesteps"]).long(),
                           noise=torch.from_numpy(js["noise"]))
    return dict(model=model, state=state, before=before, loss_dict=loss_dict)


# --------------------------------------------------------------------------- #
# losses on the same predictions and targets
# --------------------------------------------------------------------------- #

def _loss_inputs(seed=3):
    """Seeded predictions and targets at the default widths (30 agents, 20
    modes, 8 poses, 2 cascade layers). Each predicted box is a GT box of a
    random permutation plus noise, so the detection assignment has one
    optimum with a margin: the two packages' costs differ in the last bit
    (exp/log), which must not pick another optimum of near-equal cost."""
    rng = np.random.default_rng(seed)
    L, M, P, N = 2, 20, 8, 30
    gt_states = rng.normal(0, 10, (B, N, 5)).astype(np.float32)
    perm = np.stack([rng.permutation(N) for _ in range(B)])
    pred_states = np.take_along_axis(gt_states, perm[..., None], 1) + rng.normal(0, 0.5, (B, N, 5))
    preds = {
        "poses_reg_layers": rng.normal(0, 5, (L, B, M, P, 3)).astype(np.float32),
        "poses_cls_layers": rng.normal(0, 2, (L, B, M)).astype(np.float32),
        "plan_anchor": rng.normal(0, 10, (B, M, P, 2)).astype(np.float32),
        "trajectory": rng.normal(0, 5, (B, P, 3)).astype(np.float32),
        "agent_states": pred_states.astype(np.float32),
        "agent_labels": rng.normal(0, 2, (B, N)).astype(np.float32),
        "bev_semantic_map": rng.normal(0, 1, (B, 16, 32, 7)).astype(np.float32),
    }
    targets = {
        "trajectory": rng.normal(0, 5, (B, P, 3)).astype(np.float32),
        "agent_states": gt_states,
        "agent_labels": rng.uniform(size=(B, N)) > 0.6,
        "bev_semantic_map": rng.integers(0, 7, (B, 16, 32)).astype(np.int32),
    }
    return preds, targets


def _loss_pair(name, preds, targets, cfg):
    """(JAX value, port value) of loss function `name` on the same inputs."""
    jp = {k: jnp.asarray(v) for k, v in preds.items()}
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in preds.items()}
    tt = {k: torch.from_numpy(np.asarray(v)) for k, v in targets.items()}
    valid = targets["agent_labels"].astype(np.float32)
    if name == "sigmoid_focal_loss":
        onehot = np.eye(20, dtype=np.float32)[np.arange(B) * 7 % 20]
        args = (preds["poses_cls_layers"][0], onehot)
        return (jlosses.sigmoid_focal_loss(*map(jnp.asarray, args)),
                plosses.sigmoid_focal_loss(*map(torch.from_numpy, args)))
    if name == "single_layer_trajectory_loss":
        args = (preds["poses_reg_layers"][1], preds["poses_cls_layers"][1], targets["trajectory"],
                preds["plan_anchor"])
        return (jlosses.single_layer_trajectory_loss(*map(jnp.asarray, args), cfg),
                plosses.single_layer_trajectory_loss(*map(torch.from_numpy, args), cfg))
    if name == "diffusion_trajectory_loss":
        return (jlosses.diffusion_trajectory_loss(jp, jt, cfg)[0],
                plosses.diffusion_trajectory_loss(tp, tt, cfg)[0])
    if name == "_ce_cost":
        args = (valid, preds["agent_labels"])
        return jlosses._ce_cost(*map(jnp.asarray, args)), plosses._ce_cost(*map(torch.from_numpy, args))
    if name == "_l1_cost":
        args = (targets["agent_states"], preds["agent_states"], valid)
        return jlosses._l1_cost(*map(jnp.asarray, args)), plosses._l1_cost(*map(torch.from_numpy, args))
    if name == "agent_detection_loss":
        return (jnp.stack(jlosses.agent_detection_loss(jt, jp, cfg)),
                torch.stack(plosses.agent_detection_loss(tt, tp, cfg)))
    if name == "bev_semantic_loss":
        return jlosses.bev_semantic_loss(jp, jt), plosses.bev_semantic_loss(tp, tt)
    if name == "transfuser_loss_train":
        want, got = jlosses.transfuser_loss(jt, jp, cfg), plosses.transfuser_loss(tt, tp, cfg)
        assert set(want) == set(got)
        return jnp.stack([want[k] for k in sorted(want)]), torch.stack([got[k] for k in sorted(want)])
    assert name == "transfuser_loss_eval"  # the validation step's single-trajectory branch
    jp = {k: v for k, v in jp.items() if "layers" not in k and k != "plan_anchor"}
    tp = {k: v for k, v in tp.items() if "layers" not in k and k != "plan_anchor"}
    want, got = jlosses.transfuser_loss(jt, jp, cfg), plosses.transfuser_loss(tt, tp, cfg)
    assert set(want) == set(got)
    return jnp.stack([want[k] for k in sorted(want)]), torch.stack([got[k] for k in sorted(want)])


@pytest.mark.parametrize("name", [
    "sigmoid_focal_loss", "single_layer_trajectory_loss", "diffusion_trajectory_loss", "_ce_cost",
    "_l1_cost", "agent_detection_loss", "bev_semantic_loss", "transfuser_loss_train",
    "transfuser_loss_eval"])
def test_loss_function_matches_jax(name):
    """Each loss function on the same predictions and targets: 1e-6 relative."""
    cfg = _port_config(tiny_config())
    preds, targets = _loss_inputs()
    want, got = _loss_pair(name, preds, targets, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_detection_cost_reaching_the_assignment_is_detached_float32():
    cfg = _port_config(tiny_config())
    preds, targets = _loss_inputs()
    seen = []

    def spy(cost):
        seen.append(cost)
        return linear_sum_assignment_plain(cost)

    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in preds.items()
          if k in ("agent_states", "agent_labels")}
    tt = {k: torch.from_numpy(np.asarray(v)) for k, v in targets.items()}
    mp = pytest.MonkeyPatch()
    mp.setattr(plosses, "batched_linear_sum_assignment", spy)
    try:
        ce, l1 = plosses.agent_detection_loss(tt, tp, cfg)
    finally:
        mp.undo()
    (cost,) = seen
    assert cost.dtype == torch.float32 and cost.is_contiguous() and not cost.requires_grad
    assert cost.shape == (B, 30, 30)
    (ce + l1).backward()
    assert torch.isfinite(tp["agent_states"].grad).all()


def test_add_noise_takes_per_sample_timesteps():
    """(B,) integer timesteps, one per sample, as the training forward uses
    them: equal to JAX's `add_noise` and to a per-sample loop."""
    from diffusiondrive_tpu.ops.ddim import DDIMScheduler as JDDIM

    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (5, 20, 8, 2)).astype(np.float32)
    eps = rng.normal(size=x.shape).astype(np.float32)
    t = np.array([0, 49, 7, 7, 31], np.int64)
    sched = DDIMScheduler()
    got = sched.add_noise(torch.from_numpy(x), torch.from_numpy(eps), torch.from_numpy(t)).numpy()
    want = np.asarray(JDDIM().add_noise(jnp.asarray(x), jnp.asarray(eps), jnp.asarray(t, jnp.int32)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    for b in range(5):
        one = sched.add_noise(torch.from_numpy(x[b:b + 1]), torch.from_numpy(eps[b:b + 1]),
                              torch.from_numpy(t[b:b + 1])).numpy()
        np.testing.assert_array_equal(one[0], got[b])


# --------------------------------------------------------------------------- #
# BatchNorm in train mode (the Flax convention, biased variance)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_train_mode_matches_flax(dtype):
    """Batch statistics in float32, normalised with the biased variance, and
    running statistics updated as 0.9 old + 0.1 batch with the biased
    variance (torch's own BatchNorm would store n/(n-1) times it: 8/7 here,
    8 values per channel)."""
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, (2, 2, 2, 16)).astype(np.float32)  # NHWC, 8 values per channel
    scale, bias = rng.uniform(0.5, 1.5, 16).astype(np.float32), rng.normal(size=16).astype(np.float32)
    mean0, var0 = rng.normal(size=16).astype(np.float32), rng.uniform(0.5, 2, 16).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jdt)
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean0, "var": var0}}
    want, mutated = flax_bn.apply(variables, jnp.asarray(x, jdt), mutable=["batch_stats"])

    bn = BatchNorm2d(16, dtype).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    got = bn(torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2))
    assert got.dtype == dtype
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(got.detach().float().permute(0, 2, 3, 1).numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(mutated["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(mutated["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-7)
    xs = torch.from_numpy(x).to(dtype).double().reshape(-1, 16).numpy()
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 * var0 + 0.1 * xs.var(0), rtol=1e-5)


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


# --------------------------------------------------------------------------- #
# the training forward and one train step against JAX
# --------------------------------------------------------------------------- #

def test_forward_train_matches_jax(jax_step):
    js = jax_step
    model = _port_model(js)
    with torch.no_grad():
        got = model(*(torch.from_numpy(js["batch"][k]) for k in
                      ("camera_feature", "lidar_feature", "status_feature")),
                    targets=None, timesteps=torch.from_numpy(js["timesteps"]).long(),
                    diffusion_noise=torch.from_numpy(js["noise"]))
    want = js["outputs"]
    assert set(got) == set(want)
    for k in sorted(want):
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-3, atol=1e-3, err_msg=k)
    np.testing.assert_array_equal(got["poses_cls_layers"][-1].argmax(-1).numpy(),
                                  want["poses_cls_layers"][-1].argmax(-1))


def test_train_step_losses_match_jax(jax_step, port_step):
    js = jax_step
    cost = np.asarray(10.0 * jlosses._ce_cost(jnp.asarray(js["batch"]["agent_labels"]),
                                               jnp.asarray(js["outputs"]["agent_labels"]))
                      + jlosses._l1_cost(jnp.asarray(js["batch"]["agent_states"]),
                                         jnp.asarray(js["outputs"]["agent_states"]),
                                         jnp.asarray(js["batch"]["agent_labels"])))
    for c, v in zip(cost, js["batch"]["agent_labels"]):
        assert assignment_margin(c, v) > 1e-2  # one optimum: both packages must find it
    want, got = jax_step["loss_dict"], port_step["loss_dict"]
    assert set(got) == set(want)
    for k in sorted(want):
        assert got[k].ndim == 0 and not got[k].requires_grad
        # the forward's absolute error (<= 1e-3) carries into an L1 mean: 1e-3 * max(1, |JAX|)
        assert abs(got[k].item() - float(want[k])) <= 1e-3 * max(1.0, abs(float(want[k]))), k


def test_train_step_gradients_match_jax(jax_step, port_step):
    """Every parameter's gradient, under the port's names, within 1e-3 of
    that parameter's largest JAX gradient (+ 1e-6 of the largest of all)."""
    model = port_step["model"]
    want = {k: v.numpy() for k, v in jax_params_to_named(jax_step["grads"], model).items()}
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for k, limit in _grad_limits(want).items():
        g = got[k].grad
        assert g is not None, k
        err = float(np.abs(g.numpy() - want[k]).max())
        assert err <= limit, f"{k}: max |g - g_jax| {err} > {limit}"


def _grad_limits(grads):
    top = max(float(np.abs(g).max()) for g in grads.values())
    return {k: 1e-3 * float(np.abs(g).max()) + 1e-6 * top for k, g in grads.items()}


def test_train_step_updated_params_and_bn_stats_match_jax(jax_step, port_step):
    model = port_step["model"]
    new = {k: v.numpy() for k, v in jax_params_to_named(jax_step["new_params"], model).items()}
    grads = {k: v.numpy() for k, v in jax_params_to_named(jax_step["grads"], model).items()}
    top = max(float(np.abs(g).max()) for g in grads.values())
    flipped = total = 0
    for k, p in model.named_parameters():
        lr = LR0 * (0.5 if "image_encoder" in k else 1.0)
        g_p, g_j = p.grad.double().numpy(), grads[k].astype(np.float64)
        diff = np.abs(p.detach().double().numpy() - new[k])
        flip = np.sign(g_p) != np.sign(g_j)
        # same sign: 1e-5 relative, plus twice what the gradients' own
        # difference moves Adam's first update lr*g/(|g|+eps) (eps 1e-8)
        sens = 2.0 * lr * 1e-8 * np.abs(g_p - g_j) / ((np.abs(g_p) + 1e-8) * (np.abs(g_j) + 1e-8))
        limit = 1e-5 * np.abs(new[k]) + 1e-7 + sens
        assert (diff[~flip] <= limit[~flip]).all(), f"{k}: max diff/limit {(diff / limit)[~flip].max()}"
        # opposite signs: the update is +-lr on either side
        assert (diff[flip] <= 2 * lr).all(), k
        if np.abs(g_j).max() > 1e-6 * top:  # not a gradient that is zero but for rounding
            assert flip.mean() <= 1e-2, f"{k}: the sign of g differs in {flip.mean():.2%} of elements"
        flipped, total = flipped + int(flip.sum()), total + flip.size
    assert flipped <= 1e-3 * total, (flipped, total)  # measured: 2449 of 40195727
    # the BN running statistics after the step (biased variance, momentum 0.9)
    stats = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax_step["new_bs"])[0]:
        keys = [p.key for p in path]
        stats[".".join(keys[:-1] + [{"mean": "running_mean", "var": "running_var"}[keys[-1]]])] = leaf
    buffers = dict(model.named_buffers())
    assert stats and set(stats) <= set(buffers)
    for k, v in stats.items():
        np.testing.assert_allclose(buffers[k].numpy(), v, rtol=1e-5, atol=1e-5, err_msg=k)


def test_optimizer_groups_follow_param_labels(jax_step):
    """A parameter is in the image-encoder group (LR x0.5) iff JAX labels it
    so; weight decay on every parameter."""
    js = jax_step
    model = DiffusionDriveModel(_port_config(js["jcfg"]))
    labels = _param_labels(js["variables"]["params"])
    flags = jax.tree_util.tree_map(lambda lab, p: np.full(np.shape(p), lab == "image_encoder", np.float32),
                                   labels, js["variables"]["params"])
    want = {k: bool(v.flatten()[0]) for k, v in jax_params_to_named(flags, model).items()}
    optimizer, _ = build_optimizer(OptimizerConfig(), model)
    group_of = {id(p): g["label"] for g in optimizer.param_groups for p in g["params"]}
    names = dict(model.named_parameters())
    assert sum(len(g["params"]) for g in optimizer.param_groups) == len(names)
    for k, p in names.items():
        assert (group_of[id(p)] == "image_encoder") == want[k], k
    assert any(want.values()) and not all(want.values())
    assert all(g["weight_decay"] == 1e-4 for g in optimizer.param_groups)


@pytest.mark.parametrize("steps_per_epoch", [1, 7])
def test_lr_schedule_matches_jax(steps_per_epoch):
    """The optimiser's rate at steps 0..N (warm-up and cosine) in both groups
    against the JAX schedule; the port's `warmup_cos_lr` likewise."""
    cfg = OptimizerConfig(epochs=12, warmup_epochs=3, steps_per_epoch=steps_per_epoch)
    model = DiffusionDriveModel(_port_config(tiny_config()))
    optimizer, scheduler = build_optimizer(cfg, model)
    n = cfg.epochs * steps_per_epoch + 3
    for step in range(n):
        for g in optimizer.param_groups:
            m = cfg.image_encoder_lr_mult if g["label"] == "image_encoder" else 1.0
            want = float(j_warmup_cos_lr(cfg.lr * m, cfg.min_lr * m, cfg.epochs, cfg.warmup_epochs,
                                         steps_per_epoch)(step))
            # JAX evaluates in float32: a few float32 ulps of lr apart
            assert g["lr"] == pytest.approx(want, rel=1e-6, abs=1e-10), (step, g["label"])
            assert warmup_cos_lr(cfg.lr * m, cfg.min_lr * m, cfg.epochs, cfg.warmup_epochs,
                                 steps_per_epoch)(step) == g["lr"]
        optimizer.step()
        scheduler.step()


def test_global_norm_clipping_uses_optax_formula():
    from diffusiondrive_torch.training.train import clip_by_global_norm_

    rng = np.random.default_rng(1)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    for c in (0.5, 100.0):
        params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        clip_by_global_norm_(params, c)
        want, _ = optax.clip_by_global_norm(c).update([jnp.asarray(g) for g in grads], None)
        for p, w in zip(params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6)


# --------------------------------------------------------------------------- #
# data: the cache, the target builder
# --------------------------------------------------------------------------- #

def test_cache_only_dataset_yields_jax_batches(tmp_path):
    """One cache directory (written by the JAX package's `dump_feature_target`
    and by the port's) -> equal batches, in the same order."""
    from diffusiondrive_tpu.agents.diffusiondrive.features import (
        TransfuserFeatureBuilder as JFeat, TransfuserTargetBuilder as JTarg)
    from diffusiondrive_tpu.training import dataset as jds

    from diffusiondrive_torch.agents.diffusiondrive.features import (
        TransfuserFeatureBuilder, TransfuserTargetBuilder)
    from diffusiondrive_torch.entry import example_training_sample
    from diffusiondrive_torch.training import dataset as pds

    jcfg = tiny_config()
    cfg = _port_config(jcfg)
    rng = np.random.default_rng(9)
    for log, dump in (("log_a", jds.dump_feature_target), ("log_b", pds.dump_feature_target)):
        for i in range(3):
            d = tmp_path / log / f"tok_{i}"
            d.mkdir(parents=True)
            feats, targs = example_training_sample(cfg, rng)
            dump(feats, d / "transfuser_feature.gz")
            dump(targs, d / "transfuser_target.gz")
    (tmp_path / "log_b" / "incomplete").mkdir()  # no files: skipped by both
    jset = jds.CacheOnlyDataset(str(tmp_path), [JFeat(jcfg)], [JTarg(jcfg)])
    pset = pds.CacheOnlyDataset(str(tmp_path), [TransfuserFeatureBuilder(cfg)], [TransfuserTargetBuilder(cfg)])
    assert len(pset) == len(jset) == 6 and pset.tokens == jset.tokens
    for shuffle, drop_last in ((True, True), (False, False)):
        jb = list(jds.batch_iterator(jset, 4, shuffle=shuffle, seed=3, drop_last=drop_last, num_workers=2))
        pb = list(pds.batch_iterator(pset, 4, shuffle=shuffle, seed=3, drop_last=drop_last, num_workers=2))
        assert len(pb) == len(jb) == (1 if drop_last else 2)
        for a, b in zip(jb, pb):
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_target_builder_matches_jax_on_the_synthetic_scene(tmp_path):
    """The synthetic straight-road scene with its map API, plus boxes of
    every stamped class and vehicles out of range or beyond the 30 slots."""
    from diffusiondrive_tpu.agents.diffusiondrive.features import TransfuserTargetBuilder as JTarg
    from diffusiondrive_tpu.common.dataclasses import Annotations, SceneFilter, SensorConfig
    from diffusiondrive_tpu.common.dataloader import SceneLoader
    from diffusiondrive_tpu.utils.synthetic import build_synthetic_log, make_straight_map

    from diffusiondrive_torch.agents.diffusiondrive.features import TransfuserTargetBuilder

    logs, blobs = build_synthetic_log(tmp_path)
    loader = SceneLoader(logs, blobs, SceneFilter(num_history_frames=4, num_future_frames=10,
                                                  frame_interval=14),
                         SensorConfig.build_no_sensors(), build_map_api=False)
    scene = loader.get_scene_from_token(loader.tokens[0])
    scene.map_api = make_straight_map()
    rng = np.random.default_rng(2)
    names = ["vehicle"] * 34 + ["pedestrian", "barrier", "traffic_cone", "czone_sign", "generic_object",
                                "bicycle", "vehicle"]
    boxes = np.zeros((len(names), 7), np.float32)
    boxes[:, :2] = rng.uniform(-30, 30, (len(names), 2))
    boxes[-1, :2] = (40.0, 3.0)  # out of range
    boxes[:, 3:6] = rng.uniform(0.5, 5.0, (len(names), 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, len(names))
    idx = scene.scene_metadata.num_history_frames - 1
    scene.frames[idx].annotations = Annotations(boxes, names, np.zeros((len(names), 3), np.float32),
                                                [f"i{k}" for k in range(len(names))],
                                                [f"t{k}" for k in range(len(names))])
    for jcfg in (tiny_config(), None):
        from diffusiondrive_tpu.models.config import TransfuserConfig as JConfig

        jcfg = jcfg or JConfig()
        want = JTarg(jcfg).compute_targets(scene)
        got = TransfuserTargetBuilder(_port_config(jcfg)).compute_targets(scene)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["agent_labels"].sum() == 30
        assert set(np.unique(got["bev_semantic_map"])) >= {0, 1, 3, 4, 5, 6}


def test_state_array_helpers_match_jax():
    from diffusiondrive_tpu.evaluate import state_array as jsa

    from diffusiondrive_torch.evaluate import state_array as psa

    rng = np.random.default_rng(0)
    states = rng.normal(0, 5, (4, 6, 11))
    np.testing.assert_array_equal(psa.state_array_to_coords_array(states),
                                  jsa.state_array_to_coords_array(states))
    coords = psa.state_array_to_coords_array(states)
    np.testing.assert_array_equal(psa.coords_to_exterior(coords), jsa.coords_to_exterior(coords))
    args = [rng.normal(size=5) for _ in range(5)]
    np.testing.assert_array_equal(psa.box_to_corners(*args), jsa.box_to_corners(*args))
    t = torch.from_numpy(states)
    np.testing.assert_allclose(psa.state_array_to_coords_array(t, xp=torch).numpy(),
                               jsa.state_array_to_coords_array(states), rtol=1e-12, atol=1e-12)


# --------------------------------------------------------------------------- #
# the trainer, the agent, the CLI
# --------------------------------------------------------------------------- #

def _tiny_cache(root, n, seed=0):
    from diffusiondrive_torch.entry import write_example_cache

    return write_example_cache(root, _port_config(tiny_config()), n, seed=seed)


def _trainer(cfg, out, ema=True):
    from diffusiondrive_torch.entry import build_model
    from diffusiondrive_torch.training.trainer import Trainer

    opt = OptimizerConfig(epochs=3, warmup_epochs=1, steps_per_epoch=2, ema_decay=0.9 if ema else None)
    return Trainer(build_model(cfg, seed=0), cfg, opt, output_dir=str(out), seed=4)


def test_trainer_checkpoint_resume_equals_straight_run(tmp_path):
    """2 epochs, a checkpoint and a resumed third epoch end in the state of 3
    straight epochs (parameters, BN statistics, optimiser, EMA, step), and
    metrics.jsonl has one train row per step."""
    from diffusiondrive_torch.agents.diffusiondrive.features import (
        TransfuserFeatureBuilder, TransfuserTargetBuilder)
    from diffusiondrive_torch.training.dataset import CacheOnlyDataset, batch_iterator

    cfg = _port_config(tiny_config())
    cache = _tiny_cache(tmp_path / "cache", 4)
    ds = CacheOnlyDataset(str(cache), [TransfuserFeatureBuilder(cfg)], [TransfuserTargetBuilder(cfg)])
    batches = lambda epoch: batch_iterator(ds, 2, seed=epoch, num_workers=2)  # noqa: E731

    straight = _trainer(cfg, tmp_path / "straight")
    straight.fit(batches, 3)
    first = _trainer(cfg, tmp_path / "first")
    first.fit(batches, 2, val_batches=lambda e: batch_iterator(ds, 2, shuffle=False, num_workers=2))
    assert first.state.step == 4 and (tmp_path / "first" / "epoch_0001" / "state.pt").exists()
    assert {"ema_loss", "ade", "fde", "ema_fde"} <= set(first.last_val_metrics)
    resumed = _trainer(cfg, tmp_path / "resumed")
    resumed.restore_checkpoint(tmp_path / "first" / "epoch_0001")
    assert resumed.epochs_done == 2
    resumed.fit(batches, 3)

    assert resumed.state.step == straight.state.step == 6
    for (k, a), b in zip(straight.model.state_dict().items(), resumed.model.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)
    for k, a in straight.state.ema_params.items():
        torch.testing.assert_close(resumed.state.ema_params[k], a, rtol=0, atol=0, msg=k)
        assert a.data_ptr() != dict(straight.model.named_parameters())[k].data_ptr()
    sa, sb = straight.state.optimizer.state_dict(), resumed.state.optimizer.state_dict()
    for i, st in sa["state"].items():
        for name in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(sb["state"][i][name], st[name], rtol=0, atol=0)
    assert [g["lr"] for g in sa["param_groups"]] == [g["lr"] for g in sb["param_groups"]]

    rows = [json.loads(line) for line in (tmp_path / "straight" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if r["split"] == "train"] == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(r["loss"]) for r in rows)
    vals = [json.loads(line) for line in (tmp_path / "first" / "metrics.jsonl").read_text().splitlines()
            if '"val"' in line]
    assert [r["epoch"] for r in vals] == [0, 1]


def test_agent_training_interface_and_trainer_checkpoint(tmp_path):
    from diffusiondrive_torch.agents.diffusiondrive.agent import DiffusionDriveAgent
    from diffusiondrive_torch.agents.diffusiondrive.features import TransfuserTargetBuilder
    from diffusiondrive_torch.training.callbacks import TimeLoggingCallback
    from diffusiondrive_torch.training.dataset import CacheOnlyDataset, batch_iterator

    cfg = _port_config(tiny_config())
    cache = _tiny_cache(tmp_path / "cache", 2)
    trainer = _trainer(cfg, tmp_path / "out")
    agent = DiffusionDriveAgent(cfg, dtype=torch.float32, device="cpu")
    ds = CacheOnlyDataset(str(cache), agent.get_feature_builders(), agent.get_target_builders())
    trainer.fit(lambda e: batch_iterator(ds, 2, num_workers=1), 1)
    assert isinstance(agent.get_target_builders()[0], TransfuserTargetBuilder)
    assert [type(c) for c in agent.get_training_callbacks(str(tmp_path))] == [TimeLoggingCallback]
    optimizer, scheduler = agent.get_optimizers()
    assert {g["label"] for g in optimizer.param_groups} == {"default", "image_encoder"}

    for use_ema, src in ((False, dict(trainer.model.named_parameters())), (True, trainer.state.ema_params)):
        loaded = DiffusionDriveAgent(cfg, checkpoint_path=str(tmp_path / "out" / "epoch_0000"),
                                     dtype=torch.float32, device="cpu", use_ema=use_ema)
        loaded.initialize()
        assert not loaded.model.training
        for k, p in loaded.model.named_parameters():
            torch.testing.assert_close(p, src[k].detach(), rtol=0, atol=0, msg=k)
    features, targets = ds[0]
    feats = {k: np.asarray(v)[None] for k, v in features.items()}
    preds = {k: torch.from_numpy(v) for k, v in loaded.forward(feats).items()}
    loss = loaded.compute_loss(feats, {k: torch.from_numpy(np.asarray(v)[None]) for k, v in targets.items()},
                               preds)
    assert loss.ndim == 0 and torch.isfinite(loss)


def test_run_training_cli(tmp_path, monkeypatch):
    import yaml

    from diffusiondrive_torch.script import run_training

    cache = _tiny_cache(tmp_path / "cache", 2)
    jcfg = tiny_config()
    agent_cfg = tmp_path / "agent.yaml"
    agent_cfg.write_text(yaml.safe_dump({"config": {
        k: getattr(jcfg, k) for k in ("image_architecture", "lidar_architecture", "camera_height",
                                      "camera_width", "lidar_resolution_height", "lidar_resolution_width",
                                      "img_vert_anchors", "img_horz_anchors", "lidar_vert_anchors",
                                      "lidar_horz_anchors", "bev_pixel_height", "bev_pixel_width")}}))
    base = ["run_training", "--cache-path", str(cache), "--agent-config", str(agent_cfg), "--device", "cpu",
            "--output-dir", str(tmp_path / "out"), "--epochs", "1", "--batch-size", "2"]
    monkeypatch.setattr(sys, "argv", base + ["--cache-only"])
    run_training.main()
    rows = (tmp_path / "out" / "metrics.jsonl").read_text().splitlines()
    assert len(rows) == 1 and (tmp_path / "out" / "epoch_0000" / "state.pt").exists()
    for extra, match in ((["--cache-only", "--config", "x"], "ROADMAP item 17"), ([], "ROADMAP item 17"),
                         (["--cache-only", "--agent", "ego_status_mlp_agent"], "ROADMAP item 17")):
        monkeypatch.setattr(sys, "argv", base + extra)
        with pytest.raises(NotImplementedError, match=match):
            run_training.main()
