"""The plain reference against the program at a tiny configuration on the
CPU (the test may import both; the reference imports nothing of the
program), its Hungarian against brute force, and its precisions."""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from benchmark import reference
from benchmark.harness import cells, data, program
from benchmark.harness.compare import train_numbers
from benchmark.harness.weights import make_weights
from benchmark.reference.loss import hungarian
from benchmark.reference.precision import Precision
from benchmark.tests.tiny import AGENT_TRAFFIC, TRAIN_TRAFFIC, tiny_doc

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def agent():
    torch.manual_seed(0)
    a = program.build_agent(tiny_doc(), CPU, preprocess_on_device=True)
    return a, program.config_as_run(a)


def test_eval_forward_on_raw_sensors_matches_the_program(agent):
    a, cfg = agent
    W = make_weights(program.weight_specs(a.model), 2 ** 31 + 5, cfg["num_poses"], CPU)
    a.model.load_state_dict(W)
    inputs, noise = data.sensor_batches(cfg, AGENT_TRAFFIC, 7, CPU)[0]
    got = a.predict(inputs, diffusion_noise=noise)
    want = reference.predict(W, cfg, inputs, noise, Precision("float32"), rows=3)
    for k in ("trajectory", "poses_reg", "poses_cls"):
        assert torch.allclose(got[k].float(), want[k], atol=1e-4, rtol=1e-4), k


def test_training_steps_match_the_program(agent):
    a, cfg = agent
    W = make_weights(program.weight_specs(a.model), 11, cfg["num_poses"], CPU)
    a.model.load_state_dict(W)
    start = {k: v.clone() for k, v in W.items()}
    opt = {"lr": 6e-4, "min_lr": 1e-6, "weight_decay": 1e-4, "epochs": 100, "warmup_epochs": 3,
           "steps_per_epoch": 1, "image_encoder_lr_mult": 0.5}
    pool = data.training_pool(cfg, TRAIN_TRAFFIC, 11, CPU)[:3]
    trainer, opt = program.make_trainer(a, opt, 11)
    losses, outputs, grads, change = cells.checked_steps(trainer, a.model, start, pool)
    ref = cells.reference_train(start, cfg, opt, pool, 11, CPU, "float32")
    numbers = train_numbers(losses, outputs, grads, change, ref)
    # float32 on both sides: the first step's outputs and loss agree to
    # round-off; its gradients through a detection assignment that a near
    # tie may flip to ~3e-3; the later steps' losses move with Adam's
    # sign-like first updates (PERF.md)
    tolerances = {"poses_err": 1e-4, "bev_err": 1e-4, "loss_gap": 1e-4, "grad_err": 1e-2}
    for k, tol in tolerances.items():
        assert numbers[k] < tol, (k, numbers[k])
    assert np.allclose(losses, ref["losses"], rtol=1e-2)


def test_hungarian_is_optimal():
    rng = np.random.default_rng(3)
    for n in (1, 2, 4, 6):
        for _ in range(20):
            cost = rng.integers(0, 5, (n, n)).astype(float)   # ties too
            cols = hungarian(cost)
            best = min(sum(cost[i, p[i]] for i in range(n)) for p in itertools.permutations(range(n)))
            assert sorted(cols) == list(range(n)) and cost[np.arange(n), cols].sum() == best


def test_precisions_round_where_they_say():
    x = torch.tensor([1.0 + 2 ** -10, 3.3, 1000.0], requires_grad=True)
    assert torch.equal(Precision("float32").operand(x), x)
    assert Precision("bfloat16").operand(x)[0] == 1.0
    low = Precision("float8").operand(x)
    assert low[1] == 3.25 and low[2] == 448.0            # e4m3: 3 mantissa bits, largest finite 448
    y = Precision("float8").output(x * 1.0)
    y.backward(torch.full((3,), 0.3))
    assert torch.all(x.grad == 0.3125)                  # e5m2 rounds the gradient
