"""Batched PDMS evaluation runner (counterpart of `diffusiondrive_tpu/evaluate/runner.py`).

Replaces the Ray fan-out of `run_pdm_score.py:35-142`: host threads overlap
IO + feature building with the device's work on the previous batch, the
device runs (1) the batched agent forward and (2) the batched simulate +
score of `evaluate/pdm_score.py`. Tokens become a batch dimension; across
hosts, shard the token list (see `shard_tokens_for_host`).

Per-token failures are quarantined as `valid=False` rows; if the batched
scoring raises, each token is retried alone (logged at ERROR by this
module's logger). The CSV (per-token sub-scores + average row) has the
columns of `run_pdm_score.py:144-154` and is written with the `csv` module.
"""

from __future__ import annotations

import csv
import logging
import math
import os
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from diffusiondrive_torch.agents.abstract_agent import AbstractAgent
from diffusiondrive_torch.common.dataclasses import PDMResults, Trajectory, TrajectorySampling
from diffusiondrive_torch.common.dataloader import MetricCacheLoader, SceneLoader
from diffusiondrive_torch.device import resolve_device
from diffusiondrive_torch.evaluate.pdm_score import batched_pdm_score
from diffusiondrive_torch.evaluate.scorer import PDMScorerConfig
from diffusiondrive_torch.evaluate.simulator import PDMSimulator

logger = logging.getLogger(__name__)

SUB_SCORE_COLUMNS = [
    "no_at_fault_collisions",
    "drivable_area_compliance",
    "ego_progress",
    "time_to_collision_within_bound",
    "comfort",
    "driving_direction_compliance",
    "score",
]


def shard_tokens_for_host(tokens: Sequence[str], host_id: int, num_hosts: int) -> List[str]:
    """Deterministic token sharding across hosts."""
    return [t for i, t in enumerate(sorted(tokens)) if i % num_hosts == host_id]


def _invalid_row(token: str) -> Dict[str, Any]:
    return {"token": token, "valid": False, **{c: np.nan for c in SUB_SCORE_COLUMNS}}


def run_pdm_score_evaluation(
    agent: AbstractAgent,
    scene_loader: SceneLoader,
    metric_cache_loader: MetricCacheLoader,
    simulator: Optional[PDMSimulator] = None,
    scorer_config: PDMScorerConfig = PDMScorerConfig(),
    batch_size: int = 32,
    num_io_threads: int = 16,
    host_id: int = 0,
    num_hosts: int = 1,
    overlap_io: Optional[bool] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> List[Dict[str, Any]]:
    """Evaluate the agent on all tokens; returns one score row per token.

    Simulation and scoring run on `device`: the card unless "cpu" is asked
    for (raises without a card otherwise). The agent runs where it was built.
    """
    device = resolve_device(device)
    simulator = simulator or PDMSimulator(TrajectorySampling(num_poses=40, interval_length=0.1))
    agent.initialize()

    tokens = sorted(set(scene_loader.tokens) & set(metric_cache_loader.tokens))
    missing = len(set(scene_loader.tokens) - set(metric_cache_loader.tokens))
    if missing:
        logger.warning("Missing metric cache for %d tokens; skipping.", missing)
    if num_hosts > 1:
        tokens = shard_tokens_for_host(tokens, host_id, num_hosts)
    logger.info("Scoring %d scenarios...", len(tokens))

    has_builders = True
    try:
        feature_builders = agent.get_feature_builders()
    except NotImplementedError:
        has_builders = False
        feature_builders = []

    rows: List[Dict[str, Any]] = []
    if overlap_io is None:
        # prefetching batch N+1's IO under batch N's device work needs a
        # spare core: on a 1-CPU host the prefetch thread only steals time
        # from the (host-bound) main loop
        overlap_io = (os.cpu_count() or 1) > 1
    num_io_threads = max(1, min(num_io_threads, 2 * (os.cpu_count() or 1)))
    pool = ThreadPoolExecutor(max_workers=num_io_threads)
    # single-slot prefetcher double-buffers batch N+1's IO under batch N's
    # device work (separate executor: a shared pool could deadlock with the
    # inner pool.map holding all workers)
    prefetcher = ThreadPoolExecutor(max_workers=1)

    try:
        def load_one(token: str):
            """Host-side IO + preprocessing for one token; exceptions become
            sentinel rows instead of killing the batch."""
            try:
                return _load_one_inner(token)
            except Exception:  # noqa: BLE001 — per-token quarantine
                logger.exception("Token %s failed during IO/preprocessing.", token)
                return token, None, None, None

        def _load_one_inner(token: str):
            cache = metric_cache_loader.get_from_token(token)
            if agent.requires_scene:
                scene = scene_loader.get_scene_from_token(token)
                return token, cache, scene.get_agent_input(), scene
            agent_input = scene_loader.get_agent_input_from_token(token)
            if has_builders:
                features = {}
                for builder in feature_builders:
                    features.update(builder.compute_features(agent_input))
                return token, cache, features, None
            return token, cache, agent_input, None

        def load_batch(batch_tokens: List[str]):
            return list(pool.map(load_one, batch_tokens))

        batches = [tokens[s : s + batch_size] for s in range(0, len(tokens), batch_size)]
        pending = prefetcher.submit(load_batch, batches[0]) if batches else None

        for batch_idx, batch_tokens in enumerate(batches):
            if pending is None:  # overlap_io=False: load only when the device is idle
                pending = prefetcher.submit(load_batch, batch_tokens)
            loaded = pending.result()
            # start the next batch's IO before touching the device
            pending = (
                prefetcher.submit(load_batch, batches[batch_idx + 1])
                if overlap_io and batch_idx + 1 < len(batches)
                else None
            )

            valid_items, trajectories = [], []
            for token, cache, payload, scene in loaded:
                if cache is None:
                    rows.append(_invalid_row(token))
                    continue
                try:
                    if has_builders:
                        # stacked below; defer forward to the batched call
                        valid_items.append((token, cache, payload))
                    else:
                        if agent.requires_scene:
                            traj = agent.compute_trajectory(payload, scene)
                        else:
                            traj = agent.compute_trajectory(payload)
                        valid_items.append((token, cache, None))
                        trajectories.append(traj)
                except Exception:  # noqa: BLE001 — per-token quarantine
                    logger.exception("Token %s failed during input/forward.", token)
                    rows.append(_invalid_row(token))

            if has_builders and valid_items:
                # one batched device forward; partial batches are padded to
                # the full batch size by repeating the last item, as in JAX
                stacked = {
                    k: np.stack([item[2][k] for item in valid_items])
                    for k in valid_items[0][2].keys()
                }
                n = len(valid_items)
                if n < batch_size:
                    stacked = {
                        k: np.concatenate([v, np.repeat(v[-1:], batch_size - n, axis=0)])
                        for k, v in stacked.items()
                    }
                predictions = agent.forward(stacked)
                poses = np.asarray(predictions["trajectory"], np.float32)[:n]
                trajectories = [Trajectory(p) for p in poses]

            if not valid_items:
                continue

            try:
                # pad to the fixed batch size, as in JAX
                caches = [item[1] for item in valid_items]
                trajs = list(trajectories)
                n_valid = len(caches)
                while len(caches) < batch_size:
                    caches.append(caches[-1])
                    trajs.append(trajs[-1])
                results = batched_pdm_score(caches, trajs, simulator, scorer_config, device)[:n_valid]
            except Exception:
                logger.exception("Batched scoring failed; falling back to per-token.")
                results = []
                for (token, cache, _), traj in zip(valid_items, trajectories):
                    try:
                        results.append(batched_pdm_score([cache], [traj], simulator, scorer_config, device)[0])
                    except Exception:
                        logger.exception("Token %s failed during scoring.", token)
                        results.append(None)

            for (token, _, _), res in zip(valid_items, results):
                if res is None:
                    rows.append(_invalid_row(token))
                else:
                    rows.append({"token": token, "valid": True, **_result_to_row(res)})
    finally:
        pool.shutdown()
        prefetcher.shutdown()
    return rows


def _result_to_row(res: PDMResults) -> Dict[str, float]:
    return {c: getattr(res, c) for c in SUB_SCORE_COLUMNS}


def _cell(value: Any) -> str:
    """One CSV cell as pandas' `to_csv` writes it: NaN empty, floats by repr."""
    if isinstance(value, float) and math.isnan(value):
        return ""
    return str(value)


def write_score_csv(rows: List[Dict[str, Any]], output_dir: Path) -> Path:
    """Per-token CSV + average row (`run_pdm_score.py:144-154`), in the
    layout of the JAX package's pandas `to_csv`: an unnamed index column,
    then token, valid and the sub-scores; the last row is "average", the
    NaN-skipping mean of each sub-score, valid when every row is."""
    num_ok = sum(bool(r["valid"]) for r in rows)
    logger.info("Successful: %d, failed: %d", num_ok, len(rows) - num_ok)
    average = {"token": "average", "valid": all(bool(r["valid"]) for r in rows)}
    for c in SUB_SCORE_COLUMNS:
        values = np.asarray([r[c] for r in rows], dtype=np.float64)
        average[c] = float(np.nanmean(values)) if (~np.isnan(values)).any() else float("nan")

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    out = output_dir / f"{datetime.now().strftime('%Y.%m.%d.%H.%M.%S')}.csv"
    columns = ["token", "valid", *SUB_SCORE_COLUMNS]
    with open(out, "w", newline="") as fp:
        writer = csv.writer(fp)
        writer.writerow(["", *columns])
        for i, row in enumerate([*rows, average]):
            writer.writerow([i, *(_cell(row[c]) for c in columns)])
    logger.info("Average score %.4f -> %s", average["score"], out)
    return out
