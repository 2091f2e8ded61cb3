"""The two kinds of cell a traffic file can ask for ("kind"):

- "train": a closed loop of training steps through `Trainer.fit`, fed from
  a pool of numpy batches;
- "agent": a closed loop of `DiffusionDriveAgent.predict` on raw sensors on
  the device, each batch's trajectory brought to the host.

Each builds the program, makes its weights and inputs from the seed,
checks its first outputs against the reference, warms up until a round's
time is steady, measures for `seconds` (and, traced, a short window under
the profiler), then frees the program and runs the reference.
"""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, List

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import reference
from benchmark.harness import compare, data, program
from benchmark.harness.trace import WINDOW, reduce
from benchmark.harness.weights import make_weights
from benchmark.reference.precision import Precision

TRAIN_RANGES = ("forward", "loss", "backward", "optimizer")
PREDICT, PLANNER = "bench.predict", "bench.planner"

# The training steps compared with the reference. The limits under
# `benchmark/limits/` were read over exactly these three (`calibrate.py`), so
# the number belongs to the limits, not to a traffic mix.
CHECKED_STEPS = 3


@dataclass(frozen=True)
class Settings:
    """How a kind of cell warms up and how long its traced window is."""

    warm_steps: int         # training steps a warm-up round (an agent round is one pass over its pool)
    warm_rounds_max: int    # warm-up rounds at most, should the round times never settle
    steady_tol: float       # warm-up ends when two rounds in a row agree within this share
    trace_steps: int        # steps or calls under the profiler: enough to average, few enough
                            # for the trace to be read well inside the run's time limit


# Training rounds of 3 steps settle within 3% (their times vary with the
# host); agent rounds are device-bound and settle within 2%.
TRAIN = Settings(warm_steps=3, warm_rounds_max=8, steady_tol=0.03, trace_steps=4)
AGENT = Settings(warm_steps=0, warm_rounds_max=8, steady_tol=0.02, trace_steps=6)


class Context:
    """What a per-layer reader reads: the traced window's `trace`, its
    `steps` (train steps or predict calls), the cell's `kind`, `cfg` (as
    run), `traffic`, `flops` (the configuration file's counts), the timed
    window's `rate` and the kernel files."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def note(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def stage(cell, name: str) -> None:
    """Note on standard error how far into set-up the run is."""
    note(f"set-up: {name} done at {time.perf_counter() - cell.clock0:.2f} s")


def sync() -> None:
    """Wait for the device (nothing to wait for on the CPU, where the tests drive a run)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def reset_peak() -> None:
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()


def peak_bytes() -> int:
    return torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0


def steady(run_round: Callable[[], None], tol: float, least: int, most: int) -> List[float]:
    """Run warm-up rounds until two in a row take times within `tol` of each other."""
    times: List[float] = []
    while len(times) < most:
        sync()
        t = time.perf_counter()
        run_round()
        sync()
        times.append(time.perf_counter() - t)
        if len(times) >= least and abs(times[-1] - times[-2]) <= tol * times[-2]:
            break
    return times


def _load(doc: dict, device: torch.device, seed: int, raw: bool = False):
    agent = program.build_agent(doc, device, preprocess_on_device=raw)
    cfg = program.config_as_run(agent)
    specs = program.weight_specs(agent.model)
    if cfg != doc["as_run"] or {k: list(s) for k, (s, _) in specs.items()} != doc["weights"]:
        raise SystemExit("the configuration as run differs from its file: the program's defaults moved")
    weights = make_weights(specs, seed, cfg["num_poses"], device)
    agent.model.load_state_dict(weights)
    return agent, cfg, weights


def _free() -> None:
    """Return the freed program's memory to the device before the reference runs."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def trainer_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The generator of training step `step`'s draws, by the trainer's rule:
    seeded from (seed + 1, step) through numpy's `SeedSequence`."""
    s = np.random.SeedSequence([seed + 1, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s))


def _traced(run: Callable[[], int], names) -> tuple:
    """(trace, launches by kernel) of `run` (which returns its step count) under the profiler."""
    before = program.kernel_launch_counters()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            sync()
            t0 = time.perf_counter()
            steps = run()
            sync()
            window = time.perf_counter() - t0
    after = program.kernel_launch_counters()
    trace = reduce(prof.profiler.kineto_results.events(), window, steps, names)
    return trace, {k: after[k] - before[k] for k in after}


# -- training ------------------------------------------------------------------------------------
def checked_steps(trainer, model, start: Dict[str, torch.Tensor], batches: List[dict]):
    """Run `batches` as the trainer's first steps, one an epoch, through
    `Trainer.fit`: (each step's loss, the first step's forward outputs and
    each parameter's gradient at step 1 as AdamW's first moment holds it, on
    the host, each parameter's change from `start`)."""
    losses, grads, first = [], {}, {}
    names = {p: n for n, p in model.named_parameters()}

    def keep(module, args, out):
        first.update({k: out[k].detach().float().cpu() for k in reference.OUTPUTS})

    hook = model.register_forward_hook(keep)
    for i, batch in enumerate(batches):
        trainer.fit(lambda _: iter([batch]), num_epochs=trainer.epochs_done + 1)
        hook.remove()
        losses.append(trainer.last_train_metrics["loss"])
        if i == 0:
            opt = trainer.state.optimizer
            beta1 = opt.param_groups[0]["betas"][0]
            grads = {n: (opt.state[p]["exp_avg"] / (1.0 - beta1)).cpu() for p, n in names.items()}
    change_norms = {n: float(torch.linalg.vector_norm(p.detach().cpu() - start[n]))
                    for n, p in model.named_parameters()}
    return losses, first, grads, change_norms


def reference_train(start: Dict[str, torch.Tensor], cfg: dict, opt: dict, batches: List[dict], seed: int,
                    device: torch.device, precision: str) -> dict:
    """The reference's steps from the weights `start` on the numpy `batches`."""
    on_device = [{k: torch.from_numpy(v).to(device) for k, v in b.items()} for b in batches]
    return reference.train({k: v.to(device) for k, v in start.items()}, cfg, opt, on_device,
                           lambda step: trainer_generator(seed, step, device), Precision(precision))


def run_train(cell, seed: int, seconds: float, trace: bool, device: torch.device) -> dict:
    doc, tr = cell.config_doc, cell.traffic
    agent, cfg, weights = _load(doc, device, seed)
    model = agent.model
    start = {k: v.detach().cpu() for k, v in weights.items()}
    del weights
    stage(cell, "program and weights")
    pool = data.training_pool(cfg, tr, seed, device)
    stage(cell, "batches")
    trainer, opt = program.make_trainer(agent, doc["optimizer"], seed)

    def epoch(batches: List[dict]) -> None:
        trainer.fit(lambda _: iter(batches), num_epochs=trainer.epochs_done + 1)

    losses, outputs, grads, change_norms = checked_steps(trainer, model, start, pool[:CHECKED_STEPS])
    stage(cell, "checked steps")

    n = len(pool)
    cursor = [CHECKED_STEPS]

    def take(k: int) -> List[dict]:
        out = [pool[(cursor[0] + j) % n] for j in range(k)]
        cursor[0] += k
        return out

    s = TRAIN
    warm = steady(lambda: epoch(take(s.warm_steps)), s.steady_tol, 2, s.warm_rounds_max)
    note(f"warm-up rounds of {s.warm_steps} steps, s: {warm}")

    count = [0]

    def timed(limit_s: float, most: int):
        def batches(_):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < limit_s and count[0] < most:
                count[0] += 1
                yield pool[(cursor[0] + count[0]) % n]
        return batches

    reset_peak()
    setup_s = time.perf_counter() - cell.clock0
    sync()
    t0 = time.perf_counter()
    trainer.fit(timed(seconds, 1 << 30), num_epochs=trainer.epochs_done + 1)
    sync()
    window = time.perf_counter() - t0
    steps = count[0]
    cursor[0] += steps + 1
    peak = peak_bytes()
    rate = steps * tr["batch"] / window
    note(f"window: {steps} steps of {tr['batch']} in {window:.3f} s")
    result = {"metrics": {"train_samples_per_s": rate, "peak_mem_gb": peak / 1e9, "setup_s": setup_s},
              "attempted": steps, "peak": peak}
    if trace:
        def run() -> int:
            count[0] = 0
            trainer.fit(timed(3600.0, s.trace_steps), num_epochs=trainer.epochs_done + 1)
            return count[0]
        tr_, launches = _traced(run, TRAIN_RANGES + (WINDOW,))
        result["ctx"] = Context(trace=tr_, launches=launches, steps=tr_.steps, kind="train", cfg=cfg, traffic=tr,
                                flops=doc["flops"], rate=rate, cfg_dtype=doc["agent_kwargs"]["dtype"])
    del trainer, agent, model, epoch
    _free()
    ref = reference_train(start, cfg, opt, pool[:CHECKED_STEPS], seed, device, "float32")
    result["numbers"] = compare.train_numbers(losses, outputs, grads, change_norms, ref)
    return result


# -- evaluation ----------------------------------------------------------------------------------
def run_agent(cell, seed: int, seconds: float, trace: bool, device: torch.device) -> dict:
    doc, tr = cell.config_doc, cell.traffic
    agent, cfg, weights = _load(doc, device, seed, raw=True)
    weights = {k: v.cpu() for k, v in weights.items()}
    stage(cell, "program and weights")
    batches = data.sensor_batches(cfg, tr, seed, device)
    stage(cell, "sensor batches")
    n = len(batches)
    served: List[List[np.ndarray]] = [[] for _ in range(n)]
    kept: List[Dict[str, torch.Tensor]] = [{} for _ in range(n)]
    i = [0]

    def call(keep: bool) -> None:
        j = i[0] % n
        inputs, noise = batches[j]
        out = agent.predict(inputs, diffusion_noise=noise)
        answer = out["trajectory"].float().cpu().numpy()
        if keep:
            served[j].append(answer)
            kept[j] = {"poses_reg": out["poses_reg"], "poses_cls": out["poses_cls"]}
        i[0] += 1

    s = AGENT
    warm = steady(lambda: [call(False) for _ in range(n)], s.steady_tol, 2, s.warm_rounds_max)
    note(f"warm-up rounds of {n} calls, s: {warm}")
    reset_peak()
    setup_s = time.perf_counter() - cell.clock0
    sync()
    t0 = time.perf_counter()
    calls = 0
    while time.perf_counter() - t0 < seconds:
        call(True)
        calls += 1
    window = time.perf_counter() - t0
    peak = peak_bytes()
    rate = calls * tr["batch"] / window
    note(f"window: {calls} calls of {tr['batch']} scenes in {window:.3f} s")
    result = {"metrics": {"eval_scenes_per_s": rate, "peak_mem_gb": peak / 1e9, "setup_s": setup_s},
              "attempted": calls, "peak": peak}
    if trace:
        state = {}

        def pre(module, args):
            state["range"] = record_function(PLANNER)
            state["range"].__enter__()

        def post(module, args, out):
            state.pop("range").__exit__(None, None, None)

        hooks = [agent.model.register_forward_pre_hook(pre), agent.model.register_forward_hook(post)]

        def run() -> int:
            for _ in range(s.trace_steps):
                with record_function(PREDICT):
                    call(False)
            return s.trace_steps
        tr_, launches = _traced(run, (PREDICT, PLANNER, WINDOW))
        for h in hooks:
            h.remove()
        result["ctx"] = Context(trace=tr_, launches=launches, steps=tr_.steps, kind="eval", cfg=cfg, traffic=tr,
                                flops=doc["flops"], rate=rate, cfg_dtype=doc["agent_kwargs"]["dtype"])
    del agent, call
    _free()
    weights = {k: v.to(device) for k, v in weights.items()}
    ref = [reference.predict(weights, cfg, b, noise, Precision("float32")) for b, noise in batches]
    result["numbers"] = compare.eval_numbers(served, kept, ref)
    return result


KINDS = {"train": run_train, "agent": run_agent}
