"""Score a submission pickle against the metric cache (no agent).

Counterpart of `diffusiondrive_tpu/script/run_pdm_score_from_submission.py`
(navsim's `run_pdm_score_from_submission.py`): the submitted trajectories
of the tokens that have a cache, in batches, through the port's
`evaluate/pdm_score.py:batched_pdm_score` on `--device` (default: the
current CUDA device; it raises without one unless `--device cpu` is
given). Reads submissions of either package (`cli_common.load_submission`).
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from diffusiondrive_torch.common.dataclasses import TrajectorySampling
from diffusiondrive_torch.common.dataloader import MetricCacheLoader
from diffusiondrive_torch.device import resolve_device
from diffusiondrive_torch.evaluate.pdm_score import batched_pdm_score
from diffusiondrive_torch.evaluate.runner import SUB_SCORE_COLUMNS, _result_to_row, write_score_csv
from diffusiondrive_torch.evaluate.scorer import PDMScorerConfig
from diffusiondrive_torch.evaluate.simulator import PDMSimulator
from diffusiondrive_torch.script.cli_common import add_device_arg, load_submission

logger = logging.getLogger(__name__)


def main(argv: Optional[Sequence[str]] = None) -> Path:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--submission", required=True)
    parser.add_argument("--metric-cache-path", required=True)
    parser.add_argument("--output-dir", default="exp")
    parser.add_argument("--batch-size", type=int, default=64)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    predictions = load_submission(args.submission)["predictions"][0]
    cache_loader = MetricCacheLoader(Path(args.metric_cache_path))
    tokens = sorted(set(predictions) & set(cache_loader.tokens))
    logger.info("Scoring %d submitted tokens", len(tokens))

    simulator = PDMSimulator(TrajectorySampling(num_poses=40, interval_length=0.1))
    rows = []
    for start in range(0, len(tokens), args.batch_size):
        batch = tokens[start:start + args.batch_size]
        caches = [cache_loader.get_from_token(t) for t in batch]
        trajs = [predictions[t] for t in batch]
        try:
            results = batched_pdm_score(caches, trajs, simulator, PDMScorerConfig(), device)
            for t, res in zip(batch, results):
                rows.append({"token": t, "valid": True, **_result_to_row(res)})
        except Exception:  # noqa: BLE001 — a failed batch becomes invalid rows, as in JAX
            logger.exception("Batch starting at %d failed.", start)
            for t in batch:
                rows.append({"token": t, "valid": False, **{c: np.nan for c in SUB_SCORE_COLUMNS}})

    out = write_score_csv(rows, Path(args.output_dir))
    print(json.dumps({"output_csv": str(out)}))
    return out


if __name__ == "__main__":
    main()
