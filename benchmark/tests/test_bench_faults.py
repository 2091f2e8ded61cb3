"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run of a tiny cell on the CPU (the harness's look
for a chip is the one step left out), judged by the real cell's limits:
a sound run is correct; the float8 control put in the program's place, a
training step that returns its state unchanged, a step that sees half of
its batch, and a served answer altered where it is produced are not.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from benchmark.harness import cells, compare
from benchmark.harness.manifest import BENCH, load_json
from benchmark.tests.tiny import TinyCell, quick

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True)
def quick_harness(monkeypatch):
    monkeypatch.setattr(cells, "TRAIN", cells.TRAIN)
    monkeypatch.setattr(cells, "AGENT", cells.AGENT)
    quick()


def correct(result: dict, cell_name: str) -> bool:
    checks = compare.judge(result["numbers"], load_json(BENCH / "limits" / f"{cell_name}.json"))
    return all(c["ok"] for c in checks.values())


@contextlib.contextmanager
def broken_train_step(mode: str):
    """`training.train.train_step` as the trainer calls it, broken: "unchanged"
    puts every parameter back after the update; "half" drops half the rows."""
    from diffusiondrive_torch.training import train, trainer

    real = train.train_step

    def step(state, config, batch, generator=None, **kw):
        if mode == "half":
            batch = {k: v[: len(v) // 2] for k, v in batch.items()}
        before = [p.detach().clone() for p in state.model.parameters()]
        out = real(state, config, batch, generator, **kw)
        if mode == "unchanged":
            with torch.no_grad():
                for p, b in zip(state.model.parameters(), before):
                    p.copy_(b)
        return out

    trainer.train_step = step
    try:
        yield
    finally:
        trainer.train_step = real


def run_train(mode=None) -> dict:
    cell = TinyCell("train", {})
    if mode is None:
        return cells.run_train(cell, SEED, 0.3, False, CPU)
    with broken_train_step(mode):
        return cells.run_train(cell, SEED, 0.3, False, CPU)


@pytest.mark.parametrize("mode", [None, "unchanged", "half"])
def test_training_run(mode):
    result = run_train(mode)
    assert correct(result, "navsim.train_b64") == (mode is None), result["numbers"]


def test_training_control_is_not_correct():
    """The reference in float8 put in the program's place."""
    cell = TinyCell("train", {})
    agent, cfg, weights = cells._load(cell.config_doc, CPU, SEED)
    from benchmark.harness import data, program

    pool = data.training_pool(cfg, cell.traffic, SEED, CPU)[:3]
    _, opt = program.make_trainer(agent, cell.config_doc["optimizer"], SEED)
    ref = cells.reference_train(weights, cfg, opt, pool, SEED, CPU, "float32")
    ctl = cells.reference_train(weights, cfg, opt, pool, SEED, CPU, "float8")
    numbers = compare.train_numbers(ctl["losses"], ctl["outputs"], ctl["grads"], ctl["change_norms"], ref)
    assert not correct({"numbers": numbers}, "navsim.train_b64"), numbers


@contextlib.contextmanager
def broken_predict(mode: str):
    """`DiffusionDriveAgent.predict` broken: "altered" moves one scene's
    trajectory by 1 m; "half" answers the second half of the batch with the
    first half's outputs."""
    from diffusiondrive_torch.agents.diffusiondrive.agent import DiffusionDriveAgent

    real = DiffusionDriveAgent.predict

    def predict(self, tensors, diffusion_noise=None):
        out = real(self, tensors, diffusion_noise)
        if mode == "altered":
            out["trajectory"] = out["trajectory"].clone()
            out["trajectory"][0, -1, 0] += 1.0
        else:
            h = len(out["trajectory"]) // 2
            out = {k: torch.cat([v[:h], v[:h]]) for k, v in out.items()}
        return out

    DiffusionDriveAgent.predict = predict
    try:
        yield
    finally:
        DiffusionDriveAgent.predict = real


@pytest.mark.parametrize("mode", [None, "altered", "half", "control"])
def test_agent_run(mode):
    cell = TinyCell("agent", {})
    if mode in (None, "control"):
        result = cells.run_agent(cell, SEED, 0.3, False, CPU)
    else:
        with broken_predict(mode):
            result = cells.run_agent(cell, SEED, 0.3, False, CPU)
    if mode == "control":      # the float8 reference's answers in the program's place
        from benchmark import reference
        from benchmark.harness import data
        from benchmark.reference.precision import Precision

        agent, cfg, weights = cells._load(cell.config_doc, CPU, SEED, raw=True)
        batches = data.sensor_batches(cfg, cell.traffic, SEED, CPU)
        ref = [reference.predict(weights, cfg, b, n, Precision("float32")) for b, n in batches]
        ctl = [reference.predict(weights, cfg, b, n, Precision("float8")) for b, n in batches]
        result["numbers"] = compare.eval_numbers([[c["trajectory"].numpy()] for c in ctl], ctl, ref)
    assert correct(result, "navsim.agent_b256") == (mode is None), result["numbers"]
    assert np.isfinite(list(result["numbers"].values())).all()
