"""Port parity of the training path's pieces against the JAX package, on the CPU.

The losses on the same predictions and targets, per-sample timesteps of
`add_noise`, BatchNorm in train mode (Flax's biased variance), the LR
schedule, global-norm clipping, the cache reader, the target builder, the
state-array helpers, the trainer's checkpoint and resume, the agent's
training interface and the training CLI (`--cache-only`, `--config` with
overrides on the scene-backed `Dataset`, and a simple agent through
`training/generic.py`). Split from `test_torch_port_train.py` (whose module
fixture runs the JAX train step) so that `--dist loadfile` spreads them
over workers.
"""

import json
import sys

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusiondrive_tpu.training import losses as jlosses
from diffusiondrive_tpu.training.scheduler import warmup_cos_lr as j_warmup_cos_lr

from diffusiondrive_torch.models.layers import BatchNorm2d
from diffusiondrive_torch.models.transfuser_model import DiffusionDriveModel
from diffusiondrive_torch.ops.ddim import DDIMScheduler
from diffusiondrive_torch.ops.hungarian import linear_sum_assignment_plain
from diffusiondrive_torch.training import losses as plosses
from diffusiondrive_torch.training.scheduler import warmup_cos_lr
from diffusiondrive_torch.training.train import OptimizerConfig, build_optimizer

from test_torch_port_model import _port_config
from test_train import tiny_config

B = 2


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
    from diffusiondrive_torch.training.callbacks import BEVVisualizationCallback, TimeLoggingCallback
    from diffusiondrive_torch.training.dataset import CacheOnlyDataset, batch_iterator

    cfg = _port_config(tiny_config())
    cache = _tiny_cache(tmp_path / "cache", 2)
    trainer = _trainer(cfg, tmp_path / "out")
    agent = DiffusionDriveAgent(cfg, dtype=torch.float32, device="cpu")
    ds = CacheOnlyDataset(str(cache), agent.get_feature_builders(), agent.get_target_builders())
    trainer.fit(lambda e: batch_iterator(ds, 2, num_workers=1), 1)
    assert isinstance(agent.get_target_builders()[0], TransfuserTargetBuilder)
    # with an output directory JAX's agent adds the BEV tiles under <output_dir>/viz
    assert [type(c) for c in agent.get_training_callbacks(str(tmp_path))] == [TimeLoggingCallback,
                                                                                BEVVisualizationCallback]
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


TINY_AGENT_KEYS = ("image_architecture", "lidar_architecture", "camera_height", "camera_width",
                   "lidar_resolution_height", "lidar_resolution_width", "img_vert_anchors", "img_horz_anchors",
                   "lidar_vert_anchors", "lidar_horz_anchors", "bev_pixel_height", "bev_pixel_width")


def test_run_training_cli(synthetic_log, tmp_path):
    """The legacy flags on a cache; `--config default_training` with
    overrides on the scene-backed `Dataset` (sensors read from disk, the
    cache written first); `ego_status_mlp_agent` through `train_agent`."""
    import yaml

    from diffusiondrive_torch.agents.ego_status_mlp_agent import EgoStatusMLPAgent
    from diffusiondrive_torch.script import run_training

    cache = _tiny_cache(tmp_path / "cache", 2)
    jcfg = tiny_config()
    agent_cfg = tmp_path / "agent.yaml"
    agent_cfg.write_text(yaml.safe_dump({"config": {k: getattr(jcfg, k) for k in TINY_AGENT_KEYS}}))
    run_training.main(["--cache-path", str(cache), "--agent-config", str(agent_cfg), "--device", "cpu",
                       "--output-dir", str(tmp_path / "out"), "--epochs", "1", "--batch-size", "2", "--cache-only"])
    rows = (tmp_path / "out" / "metrics.jsonl").read_text().splitlines()
    assert len(rows) == 1 and (tmp_path / "out" / "epoch_0000" / "state.pt").exists()

    logs_dir, blobs_dir = synthetic_log
    split = tmp_path / "split.yaml"
    split.write_text(yaml.safe_dump({"frame_interval": 1}))   # both 14-frame windows of the log
    out = tmp_path / "composed"
    run_training.main(["--device", "cpu", "--config", "default_training", f"navsim_log_path={logs_dir}",
                       f"sensor_blobs_path={blobs_dir}", f"split={split}", f"cache_path={tmp_path / 'scenes'}",
                       f"output_dir={out}", "epochs=1", "batch_size=2", "precision=fp32",
                       "agent.config.pixels_per_meter=1.0",   # the 64x64 lidar BEV of the tiny config
                       *(f"agent.config.{k}={getattr(jcfg, k)}" for k in TINY_AGENT_KEYS)])
    snap = yaml.safe_load((out / "config.yaml").read_text())
    assert snap["agent"]["config"]["camera_height"] == jcfg.camera_height and snap["device"] == "cpu"
    tokens = sorted(d.name for d in (tmp_path / "scenes" / "log_a").iterdir())
    assert tokens == ["token_003", "token_004"]
    assert all((tmp_path / "scenes" / "log_a" / t / f"transfuser_{n}.gz").exists()
               for t in tokens for n in ("feature", "target"))
    rows = [json.loads(r) for r in (out / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == 1 and np.isfinite(rows[0]["loss"]) and (out / "epoch_0000" / "state.pt").exists()

    run_training.main(["--agent", "ego_status_mlp_agent", "--device", "cpu", "--navsim-log-path", str(logs_dir),
                       "--split", str(split), "--cache-path", str(tmp_path / "ego"),
                       "--output-dir", str(tmp_path / "ego_out"), "--epochs", "2", "--batch-size", "2"])
    agent = EgoStatusMLPAgent(checkpoint_path=str(tmp_path / "ego_out" / "final.pt"), device="cpu")
    agent.initialize()
    assert agent.model.fc0.weight.shape == (512, 8)
