"""Port parity of the registry's model variants against the JAX package, on the CPU.

For each variant (`entry.VARIANTS`: `transfuser_agent`, the MLP head;
`diffusion_policy_agent`, the UNet head; and, in
`test_torch_port_variants_nuscenes.py` with these tests,
`diffusiondrive_nuscenes_agent`, ResNet-50 encoders with 6 poses and
k-means anchors) at a small size
(`tests/test_train.py:tiny_config` with one GPT and one decoder layer, the
UNet at down dims (16, 32) and 4 test steps), one jitted JAX program in
float64 (`jax.enable_x64`, the Flax model at dtype float64) gives the eval
forward with fixed noise and one train step (the training forward, the
loss, the gradients, the new BN statistics and the detection assignment),
its dropouts and draws fixed by a monkeypatch around that jit only, as in
`test_torch_port_train.py`; the port runs the same weights
(`utils/port_jax.py`), inputs and draws, its eval on the module path
(`fused_conv_mode="off"`, JAX's path off the TPU) and its step through
`entry.train_step_on(dtype=torch.float64)`.

Why float64: at these seeded weights JAX's own float32 train step lies
~4e-3 (relative L2) from the float64 step on some gradients while the
port's float32 step lies ~1e-5 from it, so a float32 comparison measures
JAX's rounding, not the port. In float64 the two agree to the rounding
both packages leave in float32 on purpose: the timestep embedding (sin and
cos of float32 arguments differ by an ulp between XLA and torch) and JAX's
token pool, whose second mean is float32 for any input (patched to the
input's dtype here). Gates: outputs, losses, the detection cost and the
BN statistics within 1e-6 (x max(1, |JAX|) for the losses), each
parameter's gradient within 1e-5 relative L2 (`entry.grad_distances`,
floored at 1e-6 of the largest gradient). The detection assignment must
be equal on every valid target, and unique (targets placed at the
predictions). Float32 parity of the new modules is in
`test_torch_port_variants.py`.
"""

import copy
import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment as scipy_lsa

from diffusiondrive_tpu.common.dataclasses import TrajectorySampling as JSampling
from diffusiondrive_tpu.models import backbone as jbackbone
from diffusiondrive_tpu.models.diffusion_head import default_plan_anchors as j_default_plan_anchors
from diffusiondrive_tpu.models.transfuser_model import DiffusionDriveModel as JModel
from diffusiondrive_tpu.training import losses as jlosses

from diffusiondrive_torch.common.dataclasses import TrajectorySampling
from diffusiondrive_torch.entry import (
    VARIANTS, grad_distances, place_targets_at_predictions, train_step_on, variant_config)
from diffusiondrive_torch.models.layers import disable_dropout
from diffusiondrive_torch.models.transfuser_model import DiffusionDriveModel
from diffusiondrive_torch.ops.hungarian import linear_sum_assignment_plain
from diffusiondrive_torch.training import losses as plosses
from diffusiondrive_torch.utils.port_jax import jax_params_to_named, load_jax_variables

from test_torch_port_model import _port_config
from test_torch_port_train import assignment_margin
from test_torch_port_variants import _to64, seeded_variables
from test_train import make_batch, tiny_config

B = 2
TOL64 = 1e-6        # float64 behind float32 timestep embeddings (test_torch_port_variants.py)
GRAD_TOL64 = 1e-5   # relative L2 per parameter
SMALL = dict(n_layer=1, tf_num_layers=1, unet_down_dims=(16, 32), unet_test_steps=4)
INPUTS = ("camera_feature", "lidar_feature", "status_feature")
TARGETS = ("trajectory", "agent_states", "agent_labels", "bev_semantic_map")


def _configs(name):
    """(head, JAX config, port config) of a registry variant at the small size."""
    head, pcfg = variant_config(name, **SMALL, **{k: getattr(tiny_config(), k) for k in (
        "camera_height", "camera_width", "lidar_resolution_height", "lidar_resolution_width", "img_vert_anchors",
        "img_horz_anchors", "lidar_vert_anchors", "lidar_horz_anchors", "bev_pixel_height", "bev_pixel_width")},
        **({} if name == "diffusiondrive_nuscenes_agent" else {"image_architecture": "resnet18",
                                                              "lidar_architecture": "resnet18"}))
    ts = pcfg.trajectory_sampling
    jcfg = dataclasses.replace(tiny_config(), **SMALL, image_architecture=pcfg.image_architecture,
                               lidar_architecture=pcfg.lidar_architecture,
                               trajectory_sampling=JSampling(time_horizon=ts.time_horizon,
                                                             interval_length=ts.interval_length))
    assert _port_config(jcfg) == dataclasses.replace(pcfg, trajectory_sampling=TrajectorySampling(
        time_horizon=4, interval_length=0.5))
    return head, jcfg, pcfg


def _draws(head, jcfg, rng):
    """(eval noise, train timesteps, train noise) for `head` (None for the MLP)."""
    P = jcfg.num_poses
    if head == "mlp":
        return None, None, None
    if head == "unet":
        return (rng.normal(size=(B, P, 3)).astype(np.float32), rng.integers(0, 1000, B).astype(np.int32),
                rng.normal(size=(B, P, 3)).astype(np.float32))
    shape = (B, jcfg.ego_fut_mode, P, 2)
    return (rng.normal(size=shape).astype(np.float32),
            rng.integers(0, jcfg.diffusion_train_max_t, B).astype(np.int32), rng.normal(size=shape).astype(np.float32))


def _pool64(x, output_size):
    """JAX's token pool with both means in the input's dtype."""
    N, H, W, C = x.shape
    oh, ow = output_size
    return x.reshape(N, oh, H // oh, ow, W // ow, C).mean(axis=(2, 4))


def _t(a, dtype=None):
    return None if a is None else torch.from_numpy(np.asarray(a)).to(dtype) if dtype else torch.from_numpy(a)


@pytest.fixture(scope="module", params=["diffusion_policy_agent", "transfuser_agent"])
def variant(request):
    """One variant's results (the nuScenes variant's fixture is in
    `test_torch_port_variants_nuscenes.py`)."""
    return variant_results(request.param)


def variant_results(name: str) -> dict:
    """The JAX program's float64 results and the port's, for one variant."""
    assert name in VARIANTS
    head, jcfg, pcfg = _configs(name)
    rng = np.random.default_rng(21)
    batch = make_batch(B, seed=5)
    batch["trajectory"] = batch["trajectory"][:, :jcfg.num_poses]
    eval_noise, timesteps, noise = _draws(head, jcfg, rng)
    constants = {"plan_anchor": j_default_plan_anchors(jcfg.ego_fut_mode, jcfg.num_poses)}
    variables = seeded_variables(JModel(jcfg, trajectory_head_type=head), *(batch[k] for k in INPUTS), seed=3,
                                 constants=constants)

    model = load_jax_variables(DiffusionDriveModel(pcfg, head), variables)
    probe = copy.deepcopy(model).train()   # a train-mode forward moves the BN running statistics
    disable_dropout(probe)
    with torch.no_grad():   # one optimal detection assignment: targets at the port's own boxes
        pred = probe(*(_t(batch[k]) for k in INPUTS), targets={"trajectory": _t(batch["trajectory"])},
                     timesteps=_t(timesteps, torch.long), diffusion_noise=_t(noise))["agent_states"].numpy()
    batch = place_targets_at_predictions(batch, pred, rng)
    b64 = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in batch.items()}

    with jax.enable_x64(True):
        jmodel = JModel(jcfg, trajectory_head_type=head, dtype=jnp.float64)
        targets = {k: jnp.asarray(b64[k]) for k in TARGETS}

        def program(params, batch_stats, constants, inputs, eval_noise):
            v = {"params": params, "batch_stats": batch_stats, "constants": constants}
            evaluated = jmodel.apply(v, *(inputs[k] for k in INPUTS), diffusion_noise=eval_noise)

            def loss_fn(p):
                outputs, mutated = jmodel.apply(
                    {**v, "params": p}, *(inputs[k] for k in INPUTS), targets=targets, train=True,
                    rngs={"diffusion": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)},
                    mutable=["batch_stats"])
                loss_dict = jlosses.transfuser_loss(targets, outputs, jcfg)
                return loss_dict["loss"], (loss_dict, mutated["batch_stats"], outputs)

            grads, (loss_dict, new_bs, outputs) = jax.grad(loss_fn, has_aux=True)(params)
            cost = (jcfg.agent_class_weight * jlosses._ce_cost(targets["agent_labels"], outputs["agent_labels"])
                    + jcfg.agent_box_weight * jlosses._l1_cost(targets["agent_states"], outputs["agent_states"],
                                                               targets["agent_labels"]))
            return evaluated, grads, loss_dict, new_bs, cost, jlosses.batched_linear_sum_assignment(cost)

        with pytest.MonkeyPatch.context() as mp:
            # JAX's token pool takes its second mean in float32 whatever the
            # input (`ops/sampling.py:adaptive_avg_pool2d`); in float64 here
            mp.setattr(jbackbone, "adaptive_avg_pool2d", _pool64)
            mp.setattr(fnn.Dropout, "__call__", lambda self, inputs, *a, **k: inputs)
            mp.setattr(jax.random, "randint", lambda *a, **k: jnp.asarray(timesteps))
            mp.setattr(jax.random, "normal", lambda *a, **k: jnp.asarray(noise, jnp.float64))
            v64 = _to64(variables)
            out = jax.jit(program)(v64["params"], v64["batch_stats"], v64.get("constants", {}),
                                   {k: jnp.asarray(b64[k]) for k in INPUTS},
                                   None if eval_noise is None else eval_noise.astype(np.float64))
        evaluated, grads, loss_dict, new_bs, cost, cols = jax.tree_util.tree_map(np.asarray, out)

    # the module path in eval too, as JAX's off the TPU: the kernels' plain
    # versions take the BatchNorm folded to a float32 affine
    model64 = load_jax_variables(DiffusionDriveModel(dataclasses.replace(pcfg, fused_conv_mode="off"), head,
                                                     dtype=torch.float64), variables).double()
    with torch.no_grad():
        got_eval = model64.eval()(*(_t(b64[k]) for k in INPUTS),
                                  diffusion_noise=_t(None if eval_noise is None else eval_noise.astype(np.float64)))
        # the port's detection cost and assignment on its training forward
        disable_dropout(model64)
        out = model64.train()(*(_t(b64[k]) for k in INPUTS), targets={"trajectory": _t(b64["trajectory"])},
                              timesteps=_t(timesteps, torch.long), diffusion_noise=_t(noise, torch.float64))
        labels = _t(b64["agent_labels"])
        got_cost = (pcfg.agent_class_weight * plosses._ce_cost(labels, out["agent_labels"])
                    + pcfg.agent_box_weight * plosses._l1_cost(_t(b64["agent_states"]), out["agent_states"], labels))
    got_cols = linear_sum_assignment_plain(got_cost.float()).numpy()
    step = train_step_on(model, pcfg, batch, _t(timesteps, torch.long), _t(noise), "cpu", torch.float64)
    return dict(name=name, head=head, jcfg=jcfg, batch=batch, model=model, evaluated=evaluated, grads=grads,
                loss_dict=loss_dict, new_bs=new_bs, cost=cost, cols=cols, got_eval=got_eval, step=step,
                got_cost=got_cost.numpy(), got_cols=got_cols)


def test_variant_eval_forward_matches_jax(variant):
    """The planner forward of each variant with the same noise, float64:
    every output (the MLP and UNet heads' single trajectory, the nuScenes
    diffusion head's 20 modes of 6 poses)."""
    got, want = variant["got_eval"], variant["evaluated"]
    assert set(got) == set(want)
    P = variant["jcfg"].num_poses
    assert got["trajectory"].shape == (B, P, 3)
    if variant["head"] != "diffusion":
        assert set(got) == {"trajectory", "agent_states", "agent_labels", "bev_semantic_map"}
    for k in sorted(want):
        assert tuple(got[k].shape) == want[k].shape and got[k].dtype == torch.float64, k
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=TOL64, atol=TOL64, err_msg=k)


def _valid_matches(cols, valid):
    """{valid target: the prediction matched to it} of one row's assignment."""
    return {int(j): i for i, j in enumerate(cols) if valid[j]}


def test_variant_train_step_losses_and_assignment_match_jax(variant):
    v = variant
    for c, valid in zip(v["cost"], v["batch"]["agent_labels"]):
        assert assignment_margin(c, valid) > 1e-2   # one optimum: both packages must find it
    # the port's assignment on its own training forward equals JAX's (and
    # scipy's) exactly on every valid target; the invalid targets' cost
    # columns are all equal, so which of them a prediction takes is a tie
    np.testing.assert_allclose(v["got_cost"], v["cost"], rtol=TOL64, atol=TOL64)
    scipy_cols = np.stack([scipy_lsa(c)[1] for c in v["cost"]])
    for b, valid in enumerate(v["batch"]["agent_labels"].astype(bool)):
        want = _valid_matches(v["cols"][b], valid)
        assert want and _valid_matches(v["got_cols"][b], valid) == want == _valid_matches(scipy_cols[b], valid)
    assert v["step"]["lap_launches"] == 0   # the CPU takes the plain version
    want, got = v["loss_dict"], v["step"]["losses"]
    assert set(got) == set(want)
    for k in sorted(want):
        assert abs(got[k] - float(want[k])) <= TOL64 * max(1.0, abs(float(want[k]))), k


def test_variant_train_step_gradients_and_bn_match_jax(variant):
    """Per parameter, the float64 gradient's relative L2 distance to JAX's
    (`entry.grad_distances`, floored at 1e-6 of the largest gradient's
    norm); the BN running statistics after the step."""
    v = variant
    model = v["model"]
    want = {k: t.double() for k, t in jax_params_to_named(v["grads"], model).items()}
    got = v["step"]["grads"]
    assert set(got) == set(want)
    if v["head"] != "diffusion":   # the single-mode L1 loss reaches every weight of the new heads
        head_params = [k for k in got if k.startswith("trajectory_head.") and k.endswith("weight")]
        assert head_params and all(want[k].abs().max() > 0 for k in head_params)
    dist = grad_distances(got, want)
    worst = max(dist, key=dist.get)
    assert dist[worst] <= GRAD_TOL64, (worst, dist[worst])
    stats = v["step"]["stats"]
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(v["new_bs"])[0]:
        keys = [p.key for p in path]
        key = ".".join(keys[:-1] + [{"mean": "running_mean", "var": "running_var"}[keys[-1]]])
        np.testing.assert_allclose(stats[key].numpy(), leaf, rtol=TOL64, atol=TOL64, err_msg=key)
        n += 1
    assert n == len(stats) and n > 0
