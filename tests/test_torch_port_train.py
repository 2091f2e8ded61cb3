"""Port parity of one train step against the JAX package, on the CPU.

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


import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.optimize import linear_sum_assignment as scipy_lsa

from diffusiondrive_tpu.models.transfuser_model import DiffusionDriveModel as JModel
from diffusiondrive_tpu.training import losses as jlosses
from diffusiondrive_tpu.training.train import OptimizerConfig as JOptimizerConfig
from diffusiondrive_tpu.training.train import _param_labels, build_optimizer as j_build_optimizer

from diffusiondrive_torch.entry import place_targets_at_predictions
from diffusiondrive_torch.models.layers import disable_dropout
from diffusiondrive_torch.models.transfuser_model import DiffusionDriveModel
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
