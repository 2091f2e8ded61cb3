"""Port parity of data parallelism against the JAX package's mesh, on the CPU.

The JAX package shards one program's batch over a mesh; the port trains
under `DistributedDataParallel` (one process a rank, gloo here) and
evaluates over a list of devices (`[cpu] * k` here). Spawned ranks meet
through a `FileStore` in the test's tmp dir (xdist runs several groups at
once) and run `tests/torch_parallel_ranks.py`; `launch` kills every rank
and fails the test when one fails or its time runs out.

- a 2-rank DDP step equals the 1-rank step on the global batch (JAX's
  `test_train_step_mesh_equivalence` tiers), and `Trainer.fit` on 2 ranks
  writes a checkpoint that a 1-rank trainer resumes;
- BatchNorm's global statistics and the box loss's global normaliser,
  from two halves in process, against Flax and JAX on the whole batch;
- scoring, `lidar_bev` and the runner over a device list against JAX's
  mesh results and the one-device runner; the dry run;
- copies of `tests/test_parallel.py` for the port's worker pool and
  process-group helpers.
"""

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusiondrive_tpu.parallel.mesh import create_mesh, shard_batch
from diffusiondrive_tpu.training import losses as jlosses

from diffusiondrive_torch.models import layers as player
from diffusiondrive_torch.models.layers import BatchNorm2d
from diffusiondrive_torch.parallel.distributed import launch
from diffusiondrive_torch.parallel.mesh import gather_rows, local_devices, pad_to_multiple, rank_rows, split_rows
from diffusiondrive_torch.training import losses as plosses

import torch_parallel_ranks as ranks
from test_torch_port_model import REPO, _port_config
from test_train import make_batch, tiny_config

SPAWN_TIMEOUT = 240.0   # seconds a spawned group may take before every rank is killed


def _file_store(tmp_path, name="store"):
    return f"file://{tmp_path / name}"


# --------------------------------------------------------------------------- #
# (a) 2-rank DDP == 1-rank on the global batch; Trainer.fit with a checkpoint
# --------------------------------------------------------------------------- #

def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-6)


def test_ddp_step_on_two_ranks_equals_one_rank_and_fit_checkpoint_resumes(tmp_path):
    """One SGD step (lr 1e-3, parameters perturbed by 0.05, as JAX's mesh
    test) with the global-norm clip and the EMA, on 2 gloo ranks against 1
    rank on the global batch of 4, whose ranks hold 15 and 18 valid agents
    (targets at the model's predictions: a unique assignment): loss terms
    within 3e-6 (agent_box_loss 2e-3), BN running statistics 1e-5,
    parameters within 5 lr (JAX's tiers), the clipped gradient the 1-rank
    one (the clip ran on the reduced gradient: its norm is the clip);
    parameters, gradients and EMA the same bits on both ranks.

    The step runs in float64. In float32 the batch split alone moves
    `agent_class_loss` by 3.9e-6 relative on this batch (and every term by
    0 in float64), float32 reordering that the 3e-6 tier does not hold; a
    missing or doubled reduction moves the terms by O(1) in either type.

    Then `Trainer.fit` on 2 ranks (2 steps, AdamW, dropout live, float32)
    writes one checkpoint from rank 0 without the `module.` prefix, which a
    1-rank trainer restores to rank 0's parameters, and its validation
    equals the 1-rank trainer's on the whole batches (1e-4; the box term
    1e-2, JAX's tier: the targets are not placed)."""
    from diffusiondrive_torch.training.trainer import CHECKPOINT_FILE, Trainer
    from diffusiondrive_torch.training.train import OptimizerConfig

    cfg = _port_config(tiny_config())
    batch = ranks.placed_batch(cfg, make_batch(4, seed=3))
    counts = batch["agent_labels"].sum(1)
    assert counts[:2].sum() != counts[2:].sum()
    samples = [({k: batch[k][i] for k in ("camera_feature", "lidar_feature", "status_feature")},
                {k: batch[k][i] for k in ("trajectory", "agent_states", "agent_labels", "bev_semantic_map")})
               for i in range(4)]

    f64 = torch.float64
    with ThreadPoolExecutor(1) as pool:   # the 1-rank step runs while the ranks do
        group = pool.submit(launch, ranks.ddp_rank, 2, args=(cfg, batch, samples, str(tmp_path), f64),
                            device="cpu", init_method=_file_store(tmp_path), timeout=SPAWN_TIMEOUT, threads=2)
        one = ranks.sgd_step(cfg, batch, torch.device("cpu"), f64)
        out = group.result()
    r0, r1 = (o["step"] for o in out)

    assert r0["metrics"] == r1["metrics"] and r0["digest"] == r1["digest"]
    for key, want in one["metrics"].items():
        tol = 2e-3 if key == "agent_box_loss" else 3e-6
        assert _rel(r0["metrics"][key], want) <= tol, (key, r0["metrics"][key], want)
    for k, want in one["stats"].items():
        np.testing.assert_allclose(r0["stats"][k].numpy(), want.numpy(), rtol=1e-5, atol=1e-5 * want.abs().max().item(),
                                   err_msg=k)
    for k, want in one["params"].items():
        assert (r0["params"][k] - want).abs().max().item() < 5.0 * ranks.LR, k
    norm = float(np.linalg.norm(list(r0["grad_norms"].values())))
    # the clip's scale is taken from a float32 norm; clipping each rank's
    # own gradient before the mean would leave a norm well below the clip
    assert norm == pytest.approx(ranks.CLIP, rel=1e-5)
    assert float(np.linalg.norm(list(one["grad_norms"].values()))) == pytest.approx(ranks.CLIP, rel=1e-5)
    for k, want in one["grads"].items():
        assert (r0["grads"][k] - want).norm().item() <= 1e-6 * max(want.norm().item(), 1e-3 * ranks.CLIP), k

    # Trainer.fit on 2 ranks: 2 steps, one checkpoint, metrics from rank 0
    f0, f1 = (o["fit"] for o in out)
    assert f0["steps"] == f1["steps"] == 2 and f0["train"] == f1["train"] and f0["params"] == f1["params"]
    assert f0["dropout_draw"] != f1["dropout_draw"]
    rows = [json.loads(r) for r in (tmp_path / "fit" / "metrics.jsonl").read_text().splitlines()]
    assert [r["split"] for r in rows] == ["train", "train", "val"]
    payload = torch.load(tmp_path / "fit" / "epoch_0000" / CHECKPOINT_FILE, weights_only=True)
    assert not any(k.startswith("module.") for k in payload["params"]) and payload["step"] == 2
    del payload
    resumed = Trainer(ranks.build_model(cfg, seed=0), cfg, OptimizerConfig(), seed=4)
    resumed.restore_checkpoint(tmp_path / "fit" / "epoch_0000")
    assert resumed.state.step == 2 and ranks.digest(dict(resumed.model.named_parameters())) == f0["params"]
    # validation: each rank's rows, the metrics averaged over the ranks, as
    # one process validates the whole batches
    from diffusiondrive_torch.training.dataset import batch_iterator

    assert f0["val"] == f1["val"]
    want = resumed._validate(batch_iterator(samples, 2, shuffle=False, num_workers=1), 0)
    assert set(want) == set(f0["val"])
    for k, w in want.items():
        tol = 1e-2 if k == "agent_box_loss" else 1e-4
        assert _rel(f0["val"][k], w) <= tol, (k, f0["val"][k], w)


@pytest.mark.parametrize("head", ["mlp", "unet"])
def test_ddp_step_of_the_mlp_and_unet_heads_on_two_ranks_equals_one_rank(tmp_path, head):
    """The MLP and UNet heads under DDP (`find_unused_parameters`: their
    steps leave `bev_proj` unused; the UNet's (B, P, 3) noise drawn for the
    global batch and sliced per rank, the MLP drawing nothing): one float64
    step with the default AdamW on 2 gloo ranks against 1 rank, at the
    gates of the diffusion head's test above (loss terms 3e-6, the box
    term 2e-3, BN statistics 1e-5, gradients 1e-6, parameters within 5 lr,
    the same bits on both ranks), and the unused `bev_proj`, its gradient
    zero, decayed to p (1 - lr wd) on every rank, as optax's AdamW decays
    a parameter with a zero gradient."""
    from diffusiondrive_torch.training.train import OptimizerConfig

    cfg = _port_config(tiny_config())
    batch = ranks.placed_batch(cfg, make_batch(4, seed=3), head)
    counts = batch["agent_labels"].sum(1)
    assert counts[:2].sum() != counts[2:].sum()
    f64 = torch.float64
    with ThreadPoolExecutor(1) as pool:
        group = pool.submit(launch, ranks.head_rank, 2, args=(cfg, batch, f64, head), device="cpu",
                            init_method=_file_store(tmp_path), timeout=SPAWN_TIMEOUT, threads=2)
        one = ranks.adamw_step(cfg, batch, torch.device("cpu"), f64, head)
        r0, r1 = group.result()

    assert r0["metrics"] == r1["metrics"] and r0["digest"] == r1["digest"]
    for key, want in one["metrics"].items():
        tol = 2e-3 if key == "agent_box_loss" else 3e-6
        assert _rel(r0["metrics"][key], want) <= tol, (key, r0["metrics"][key], want)
    for k, want in one["stats"].items():
        np.testing.assert_allclose(r0["stats"][k].numpy(), want.numpy(), rtol=1e-5, atol=1e-5 * want.abs().max().item(),
                                   err_msg=k)
    lr = OptimizerConfig().lr / 3   # WarmupCosLR at step 0, 3 warm-up epochs
    for k, want in one["params"].items():
        assert (r0["params"][k] - want).abs().max().item() <= 5.0 * lr, k
    norm, one_norm = (float(np.linalg.norm(list(r["grad_norms"].values()))) for r in (r0, one))
    assert norm == pytest.approx(one_norm, rel=1e-6)
    for k, want in one["grads"].items():
        assert (r0["grads"][k] - want).norm().item() <= 1e-6 * max(want.norm().item(), 1e-3 * one_norm), k
    assert r0["bev_proj"] and all(r0["grad_norms"][k] == 0.0 for k in r0["bev_proj"])
    for r in (r0, r1, one):
        for k, p in r["bev_proj_before"].items():
            torch.testing.assert_close(r["bev_proj"][k], p * (1.0 - lr * 1e-4), rtol=1e-12, atol=0, msg=k)


# --------------------------------------------------------------------------- #
# (b) the two global reductions from two halves, against Flax and JAX
# --------------------------------------------------------------------------- #

def _other_half(reduce_with):
    """A stand-in for the group's sum on the first half: adds the second's."""
    return lambda t: t + reduce_with


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batchnorm_global_statistics_from_two_halves_equal_flax_on_the_batch(dtype, monkeypatch):
    """Train-mode `BatchNorm2d` on the first half of a batch with the
    second half's (sum x, sum x^2, count) added by the group's sum: its
    output rows and running statistics equal Flax's `BatchNorm` on the whole
    batch, elementwise."""
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, (4, 3, 5, 16))  # NHWC
    scale, bias = rng.uniform(0.5, 1.5, 16), rng.normal(size=16)
    mean0, var0 = rng.normal(size=16), rng.uniform(0.5, 2, 16)
    npd = np.float64 if dtype == torch.float64 else np.float32
    with jax.enable_x64(dtype == torch.float64):
        jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
        flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jdt, param_dtype=jdt)
        variables = {"params": {"scale": jnp.asarray(scale, jdt), "bias": jnp.asarray(bias, jdt)},
                     "batch_stats": {"mean": jnp.asarray(mean0, jdt), "var": jnp.asarray(var0, jdt)}}
        want, mutated = flax_bn.apply(variables, jnp.asarray(x, jdt), mutable=["batch_stats"])
        want = np.asarray(want)
        want_mean, want_var = (np.asarray(mutated["batch_stats"][k]) for k in ("mean", "var"))

    bn = BatchNorm2d(16, dtype).to(dtype).train()
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, mean0), (bn.running_var, var0)):
            t.copy_(torch.from_numpy(v.astype(npd)))
    xt = torch.from_numpy(x.astype(npd)).permute(0, 3, 1, 2)
    second = xt[2:]
    sums_b = torch.cat([second.sum((0, 2, 3)), (second * second).sum((0, 2, 3)),
                        torch.full((1,), second.numel() // 16, dtype=dtype)])
    monkeypatch.setattr(player, "world_size", lambda: 2)
    monkeypatch.setattr(player, "all_reduce_sum", _other_half(sums_b))
    got = bn(xt[:2]).detach().permute(0, 2, 3, 1).numpy()
    tol = 1e-12 if dtype == torch.float64 else 2e-6
    np.testing.assert_allclose(got, want[:2], rtol=tol, atol=tol)
    np.testing.assert_allclose(bn.running_mean.numpy(), want_mean, rtol=tol, atol=tol)
    np.testing.assert_allclose(bn.running_var.numpy(), want_var, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_box_loss_global_normaliser_from_two_halves_equals_jax_on_the_batch(dtype, monkeypatch):
    """`transfuser_loss` on each half of a batch (7 and 12 valid agents) with
    the group's count summed: the mean of the halves' terms equals the
    port's loss on the whole batch (float64: 1e-12) and JAX's
    `transfuser_loss` on it, term by term (2e-6: JAX's loss upcasts its
    inputs to float32 and computes there, also under x64); one half alone,
    with no group, does not for the box loss."""
    from test_torch_port_train_loop import _loss_inputs

    preds, targets = _loss_inputs(seed=3)                      # B = 2 at the default widths
    targets["agent_labels"][0, :] = np.arange(30) < 7
    targets["agent_labels"][1, :] = np.arange(30) < 12
    cfg = _port_config(tiny_config())
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    with jax.enable_x64(dtype == np.float64):
        jax_want = jax.jit(lambda t, p: jlosses.transfuser_loss(t, p, cfg))(
            {k: jnp.asarray(v) for k, v in targets.items()}, {k: jnp.asarray(v.astype(dtype)) for k, v in preds.items()})
        jax_want = {k: float(v) for k, v in jax_want.items()}

    def port(lo, hi):
        tp = {k: torch.from_numpy(v[:, lo:hi] if "layers" in k else v[lo:hi]).to(tdt) for k, v in preds.items()}
        tt = {k: torch.from_numpy(np.asarray(v[lo:hi])) for k, v in targets.items()}
        return {k: float(v) for k, v in plosses.transfuser_loss(tt, tp, cfg).items()}

    whole = port(0, 2)
    halves = []
    for h in (0, 1):
        other = float(targets["agent_labels"][1 - h].sum())
        monkeypatch.setattr(plosses, "world_size", lambda: 2)
        monkeypatch.setattr(plosses.dist, "all_reduce", lambda t, other=other: t.add_(other))
        halves.append(port(h, h + 1))
    mean = {k: (halves[0][k] + halves[1][k]) / 2 for k in whole}
    assert set(mean) == set(jax_want)
    for k, w in whole.items():
        assert _rel(mean[k], w) <= (1e-12 if dtype == np.float64 else 2e-6), (k, mean[k], w)
        assert _rel(mean[k], jax_want[k]) <= 2e-6, (k, mean[k], jax_want[k])
    monkeypatch.setattr(plosses, "world_size", lambda: 1)
    alone = port(1, 2)["agent_box_loss"]
    assert _rel((halves[0]["agent_box_loss"] + alone) / 2, whole["agent_box_loss"]) > 1e-2


# --------------------------------------------------------------------------- #
# (c, d, e) scoring, lidar_bev and the runner over a device list
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def jax_mesh_scores(tmp_path_factory):
    """5 metric caches and one trajectory, and JAX's
    `batched_pdm_score(mesh=mesh8)` of them (`tests/test_multichip_eval.py:47`)."""
    from diffusiondrive_tpu.common.dataclasses import Trajectory as JTrajectory, TrajectorySampling as JSampling
    from diffusiondrive_tpu.common.dataloader import MetricCacheLoader as JMetricCacheLoader
    from diffusiondrive_tpu.evaluate.pdm_score import batched_pdm_score as jax_batched_pdm_score
    from diffusiondrive_tpu.evaluate.simulator import PDMSimulator as JSimulator

    from test_runner import build_caches

    cache = tmp_path_factory.mktemp("mesh_scores") / "cache"
    tokens = [f"tok_{i}" for i in range(5)]
    build_caches(tokens, cache)
    poses = np.stack([4.0 * np.arange(1, 9) * 0.5, np.zeros(8), np.zeros(8)], 1).astype(np.float32)
    jloader = JMetricCacheLoader(cache)
    want = jax_batched_pdm_score([jloader.get_from_token(t) for t in tokens], [JTrajectory(poses)] * 5,
                                 JSimulator(JSampling(num_poses=40, interval_length=0.1)),
                                 mesh=create_mesh(jax.devices()[:8]))
    return cache, tokens, poses, want


@pytest.mark.parametrize("k", [2, 8])
def test_scoring_over_a_device_list_equals_jax_mesh(jax_mesh_scores, k):
    """`batched_pdm_score(mesh=[cpu] * k)` on 5 scenes (padded to a multiple
    of k, the padding dropped) equals JAX's `batched_pdm_score(mesh=mesh8)`
    (`tests/test_multichip_eval.py:47`), atol 1e-5."""
    from diffusiondrive_torch.common.dataclasses import Trajectory, TrajectorySampling
    from diffusiondrive_torch.common.dataloader import MetricCacheLoader
    from diffusiondrive_torch.evaluate.pdm_score import batched_pdm_score
    from diffusiondrive_torch.evaluate.scorer import PDMScorerConfig
    from diffusiondrive_torch.evaluate.simulator import PDMSimulator

    cache, tokens, poses, want = jax_mesh_scores
    loader = MetricCacheLoader(cache)
    got = batched_pdm_score([loader.get_from_token(t) for t in tokens], [Trajectory(poses)] * 5,
                            PDMSimulator(TrajectorySampling(num_poses=40, interval_length=0.1)), PDMScorerConfig(),
                            mesh=[torch.device("cpu")] * k)
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        for field in ("score", "no_at_fault_collisions", "ego_progress", "comfort",
                      "time_to_collision_within_bound", "drivable_area_compliance", "driving_direction_compliance"):
            np.testing.assert_allclose(getattr(a, field), getattr(b, field), atol=1e-5, err_msg=field)


def test_lidar_bev_over_a_device_list_equals_jax_sharded():
    """`lidar_bev(mesh=[cpu] * 8)` equals JAX's `shard_map`'d splat over an
    8-device mesh exactly (`tests/test_preprocessing.py:87`)."""
    from diffusiondrive_tpu.ops.preprocessing import lidar_bev as jax_lidar_bev

    from diffusiondrive_torch.ops.preprocessing import lidar_bev

    rng = np.random.default_rng(3)
    pts = rng.uniform(-30, 30, size=(8, 4096, 3)).astype(np.float32)
    pts[..., 2] = 1.0
    valid = rng.uniform(size=(8, 4096)) > 0.1
    mesh = create_mesh(jax.devices()[:8])
    sharded = shard_batch({"p": pts, "v": valid}, mesh)
    want = np.asarray(jax_lidar_bev(sharded["p"], sharded["v"], mesh=mesh))
    got = lidar_bev(torch.from_numpy(pts), torch.from_numpy(valid), mesh=[torch.device("cpu")] * 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_runner_over_two_devices_equals_one_device(synthetic_log, tmp_path):
    """The DiffusionDrive agent (tiny config, raw sensors, float32) through
    `run_pdm_score_evaluation(mesh=[cpu, cpu])`: the batch of 5 rounds up to
    6, every row equals the one-device runner's (1e-5; discrete sub-scores
    equal), and the agent's forward ran split (one replica, the model
    itself, for the repeated device)."""
    from diffusiondrive_torch.agents.diffusiondrive.agent import DiffusionDriveAgent
    from diffusiondrive_torch.common.dataloader import MetricCacheLoader
    from diffusiondrive_torch.evaluate.runner import SUB_SCORE_COLUMNS, run_pdm_score_evaluation

    from test_runner import build_caches
    from test_torch_port_score import _InMemoryLoader

    cfg = _port_config(tiny_config())
    tokens = [f"tok_{i}" for i in range(3)]
    build_caches(tokens, tmp_path / "cache")
    loader = _InMemoryLoader(tokens, cfg)
    rows = {}
    for name, mesh in (("one", None), ("two", [torch.device("cpu")] * 2)):
        agent = DiffusionDriveAgent(cfg, dtype=torch.float32, seed=0, preprocess_on_device=True, device="cpu")
        rows[name] = run_pdm_score_evaluation(agent, loader, MetricCacheLoader(tmp_path / "cache"), batch_size=5,
                                              device="cpu", mesh=mesh)
    assert agent._mesh == [torch.device("cpu")] * 2
    assert [r["token"] for r in rows["two"]] == tokens and all(r["valid"] for r in rows["two"])
    for a, b in zip(rows["two"], rows["one"]):
        for c in SUB_SCORE_COLUMNS:
            assert abs(a[c] - b[c]) <= 1e-5, (c, a, b)


def test_runner_over_a_device_list_fails_when_a_device_fails(tmp_path, monkeypatch):
    """A device of the list that fails while scoring fails the run: the
    runner does not go on with the per-token retry on fewer devices."""
    from diffusiondrive_torch.agents.constant_velocity_agent import ConstantVelocityAgent
    from diffusiondrive_torch.common.dataloader import MetricCacheLoader
    from diffusiondrive_torch.evaluate import pdm_score
    from diffusiondrive_torch.evaluate.runner import run_pdm_score_evaluation

    from test_runner import build_caches
    from test_torch_port_score import _InMemoryLoader

    tokens = [f"tok_{i}" for i in range(3)]
    build_caches(tokens, tmp_path / "cache")
    loader = _InMemoryLoader(tokens, _port_config(tiny_config()))
    real, calls = pdm_score.simulate_and_score, []

    def second_device_fails(*args):
        calls.append(args[2].device)
        if len(calls) == 2:
            raise RuntimeError("device lost")
        return real(*args)

    monkeypatch.setattr(pdm_score, "simulate_and_score", second_device_fails)
    with pytest.raises(RuntimeError, match="device lost"):
        run_pdm_score_evaluation(ConstantVelocityAgent(), loader, MetricCacheLoader(tmp_path / "cache"),
                                 batch_size=4, device="cpu", mesh=[torch.device("cpu")] * 2)
    assert len(calls) == 2


def test_agent_forward_over_a_device_list_equals_one_device_and_copies_weights_once():
    """The agent's forward split over [cpu] * 2 equals its one-device
    forward (the noise is drawn for the whole batch); the replicas of
    another device are made once and again only after a weight changes."""
    from diffusiondrive_torch.agents.diffusiondrive.agent import DiffusionDriveAgent
    from diffusiondrive_torch.parallel.mesh import replicas

    cfg = _port_config(tiny_config())
    agent = DiffusionDriveAgent(cfg, dtype=torch.float32, seed=0, device="cpu")
    agent.initialize()
    b = make_batch(4, seed=1)
    features = {k: b[k] for k in ("camera_feature", "lidar_feature", "status_feature")}
    one = agent.forward(features)
    agent.set_mesh([torch.device("cpu")] * 2)
    two = agent.forward(features)
    for k, v in one.items():
        np.testing.assert_allclose(two[k], v, rtol=1e-5, atol=1e-4, err_msg=k)

    cache = {}
    meta = torch.device("meta")
    first = replicas(agent.model, [torch.device("cpu"), meta], cache)
    assert first[0] is agent.model and first[1] is not agent.model
    assert replicas(agent.model, [meta], cache)[0] is first[1]
    with torch.no_grad():
        next(agent.model.parameters()).add_(1.0)
    assert replicas(agent.model, [meta], cache)[0] is not first[1]


def test_dryrun_multichip_on_two_cpu_ranks(tmp_path):
    """`entry.dryrun_multichip(2, device="cpu")`: the 2-rank loss equals the
    1-rank golden within the JAX dry run's tiers, the split forward the
    one-device one, and the golden scenario scores 7/12 on each device."""
    from diffusiondrive_torch.entry import dryrun_multichip

    out = dryrun_multichip(2, device="cpu", init_method=_file_store(tmp_path), timeout=SPAWN_TIMEOUT)
    assert out["backend"] == "gloo" and out["eval_score"] == pytest.approx(7.0 / 12.0, abs=1e-4)
    assert out["loss"] == pytest.approx(out["golden"]["loss"], rel=1e-3)


def test_launch_fails_as_a_whole_when_a_rank_fails(tmp_path):
    """A rank that raises fails the launch with its traceback; the other
    rank, left waiting in a collective, is killed."""
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        launch(ranks.fail_on_rank_one, 2, device="cpu", init_method=_file_store(tmp_path), timeout=60.0, threads=1)


# --------------------------------------------------------------------------- #
# device lists, batch rows, the CLI's rule
# --------------------------------------------------------------------------- #

def test_local_devices_follow_the_mesh_devices_rule():
    cpu = torch.device("cpu")
    assert local_devices(0, "cpu") == [] and local_devices(1, "cpu") == [cpu] and local_devices(-1, "cpu") == [cpu]
    for n in (2, -2):
        with pytest.raises(ValueError, match=r"--mesh-devices must be 0 \(no mesh\), -1 \(all\) or 1\.\.1 "
                                             r"\(have 1 devices\), got " + str(n)):
            local_devices(n, "cpu")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert len(local_devices(-1)) == cards


def test_rows_split_pad_and_gather():
    assert rank_rows(8, 1, 4) == slice(2, 4)
    with pytest.raises(ValueError, match="does not split"):
        rank_rows(5, 0, 2)
    x = torch.arange(12.0).reshape(6, 2)
    chunks = split_rows({"x": x, "y": np.arange(6)}, [torch.device("cpu")] * 3)
    assert [c["x"].shape[0] for c in chunks] == [2, 2, 2] and chunks[2]["y"].tolist() == [4, 5]
    assert torch.equal(gather_rows([c["x"] for c in chunks]), x)
    padded, n = pad_to_multiple(np.arange(5), 4)
    assert n == 5 and padded.tolist() == [0, 1, 2, 3, 4, 4, 4, 4]


def test_device_scope_and_canonical_device_off_the_card():
    """Off the card a device's scope changes nothing and a device is its own
    canonical form; a replica list of the model's own device is the model."""
    from diffusiondrive_torch.parallel.mesh import canonical_device, device_scope, replicas

    cpu = torch.device("cpu")
    with device_scope("cpu"):
        assert canonical_device("cpu") == cpu
    model = torch.nn.Linear(2, 2)
    assert replicas(model, ["cpu", cpu]) == [model, model]


def test_batch_iterator_gives_each_rank_its_rows_of_the_global_batch():
    from diffusiondrive_torch.training.dataset import batch_iterator

    data = [({"x": np.array([i])}, {"y": np.array([i])}) for i in range(12)]
    whole = list(batch_iterator(data, 4, seed=3, num_workers=1))
    per_rank = [list(batch_iterator(data, 4, seed=3, num_workers=1, rank=r, world_size=2)) for r in (0, 1)]
    assert len(whole) == len(per_rank[0]) == len(per_rank[1]) == 3
    for b, (a0, a1) in enumerate(zip(*per_rank)):
        np.testing.assert_array_equal(np.concatenate([a0["x"], a1["x"]]), whole[b]["x"])
    with pytest.raises(ValueError, match="does not split"):
        list(batch_iterator(data, 3, num_workers=1, rank=0, world_size=2))


# --------------------------------------------------------------------------- #
# (g) copies of tests/test_parallel.py
# --------------------------------------------------------------------------- #

def test_worker_map_flattens():
    from diffusiondrive_torch.parallel.worker_pool import Sequential, ThreadPool, worker_map

    def per_log(item):
        return [f"{item}_{i}" for i in range(2)]

    for worker in (Sequential(), ThreadPool(max_workers=4)):
        assert worker_map(worker, per_log, ["a", "b", "c"]) == ["a_0", "a_1", "b_0", "b_1", "c_0", "c_1"]


def test_build_worker():
    from diffusiondrive_torch.parallel.worker_pool import Sequential, ThreadPool, build_worker

    assert isinstance(build_worker("sequential"), Sequential)
    assert isinstance(build_worker("thread_pool", max_workers=2), ThreadPool)


def test_token_sharding_partition():
    from diffusiondrive_torch.evaluate.runner import shard_tokens_for_host

    tokens = [f"tok_{i:03d}" for i in range(103)]
    shards = [shard_tokens_for_host(tokens, h, 4) for h in range(4)]
    assert sorted(t for shard in shards for t in shard) == sorted(tokens)
    sizes = [len(s) for s in shards]
    assert max(sizes) - min(sizes) <= 1


def test_initialize_distributed_multihost_branch(monkeypatch):
    """`init_process_group` fires exactly when a coordinator or several
    processes are configured (arguments or torchrun's environment), with
    the caller's topology forwarded; gloo for the CPU, NCCL for the card."""
    import torch.distributed as dist

    from diffusiondrive_torch.parallel.distributed import initialize_distributed

    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: calls.append(kw))
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed() == (0, 1) and calls == []

    assert initialize_distributed("10.0.0.1:8476", num_processes=4, process_id=2) == (2, 4)
    assert calls == [dict(backend="nccl", init_method="tcp://10.0.0.1:8476", world_size=4, rank=2)]

    calls.clear()
    assert initialize_distributed("file:///tmp/store", 2, 1, device="cpu") == (1, 2)
    assert calls == [dict(backend="gloo", init_method="file:///tmp/store", world_size=2, rank=1)]

    calls.clear()
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert initialize_distributed(device="cpu") == (1, 2)
    assert calls == [dict(backend="gloo", init_method="env://")]


def test_host_shard_info_env_and_default(monkeypatch):
    from diffusiondrive_torch.parallel.distributed import host_shard_info

    monkeypatch.setenv("HOST_ID", "3")
    monkeypatch.setenv("NUM_HOSTS", "8")
    assert host_shard_info() == (3, 8)
    monkeypatch.delenv("HOST_ID")
    monkeypatch.delenv("NUM_HOSTS")
    assert host_shard_info() == (0, 1)


# --------------------------------------------------------------------------- #
# (h) the data-parallel modules import no JAX
# --------------------------------------------------------------------------- #

_GUARD = r"""
import sys
sys.path.insert(0, sys.argv[1])
import diffusiondrive_torch.parallel.distributed, diffusiondrive_torch.parallel.mesh
import diffusiondrive_torch.parallel.worker_pool, diffusiondrive_torch.entry
import diffusiondrive_torch.script.run_training, diffusiondrive_torch.script.run_pdm_score
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "diffusiondrive_tpu"))
assert not bad, bad
print("ok")
"""


def test_parallel_modules_import_no_jax():
    proc = subprocess.run([sys.executable, "-c", _GUARD, str(REPO)], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr
