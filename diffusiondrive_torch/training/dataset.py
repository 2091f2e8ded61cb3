"""Feature/target cache reader (counterpart of `diffusiondrive_tpu/training/dataset.py`).

A cache holds per-token directories ``<cache>/<log>/<token>/<builder>.gz``,
each a gzip pickle of one builder's numpy dict, the JAX package's format:
the same cache directory yields the same batches, in the same order, in
both packages. `batch_iterator` collates numpy batches on host threads; the
trainer copies each batch to the device.

The scene-backed `Dataset` that computes and writes the cache from OpenScene
logs comes with the dataset slice of the port (it needs the disk loaders).
"""

from __future__ import annotations

import gzip
import pickle
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from diffusiondrive_torch.training.abstract_feature_target_builder import (
    AbstractFeatureBuilder,
    AbstractTargetBuilder,
)


def dump_feature_target(data: Dict[str, np.ndarray], path: Path) -> None:
    with gzip.open(path, "wb", compresslevel=1) as fp:
        pickle.dump(data, fp)


def load_feature_target(path: Path) -> Dict[str, np.ndarray]:
    """Read one cache file. Unpickling runs code: read only caches this
    program (or the JAX package) wrote."""
    with gzip.open(path, "rb") as fp:
        return pickle.load(fp)


class CacheOnlyDataset:
    """Every token directory of `cache_path` that holds all builders' files,
    in sorted (log, token) order."""

    def __init__(self, cache_path: str, feature_builders: List[AbstractFeatureBuilder],
                 target_builders: List[AbstractTargetBuilder], log_names: Optional[List[str]] = None):
        self._cache_path = Path(cache_path)
        self._feature_builders = feature_builders
        self._target_builders = target_builders
        names = [b.get_unique_name() for b in list(feature_builders) + list(target_builders)]
        self._token_dirs: List[Path] = []
        log_dirs = [d for d in sorted(self._cache_path.iterdir())
                    if d.is_dir() and (log_names is None or d.name in log_names)]
        for log_dir in log_dirs:
            for token_dir in sorted(log_dir.iterdir()):
                if all((token_dir / f"{n}.gz").exists() for n in names):
                    self._token_dirs.append(token_dir)

    def __len__(self) -> int:
        return len(self._token_dirs)

    @property
    def tokens(self) -> List[str]:
        return [d.name for d in self._token_dirs]

    def __getitem__(self, idx: int) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        token_dir = self._token_dirs[idx]
        features: Dict[str, np.ndarray] = {}
        targets: Dict[str, np.ndarray] = {}
        for b in self._feature_builders:
            features.update(load_feature_target(token_dir / f"{b.get_unique_name()}.gz"))
        for b in self._target_builders:
            targets.update(load_feature_target(token_dir / f"{b.get_unique_name()}.gz"))
        return features, targets


def collate(samples: List[Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]]) -> Dict[str, np.ndarray]:
    """Stack feature and target dicts into one flat batch dict."""
    batch: Dict[str, np.ndarray] = {}
    for part in (0, 1):
        for k in samples[0][part]:
            batch[k] = np.stack([np.asarray(s[part][k]) for s in samples])
    return batch


def batch_iterator(dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                   drop_last: bool = True, num_workers: int = 8) -> Iterator[Dict[str, np.ndarray]]:
    """Threaded batch loader: the gzip reads of the next batches overlap the
    device's work on the current one (4 batches ahead)."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    num_batches = len(order) // batch_size if drop_last else -(-len(order) // batch_size)

    def load_batch(b: int) -> Dict[str, np.ndarray]:
        idxs = order[b * batch_size:(b + 1) * batch_size]
        return collate([dataset[int(i)] for i in idxs])

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        prefetch = 4
        futures = {b: pool.submit(load_batch, b) for b in range(min(prefetch, num_batches))}
        for b in range(num_batches):
            batch = futures.pop(b).result()
            nxt = b + prefetch
            if nxt < num_batches:
                futures[nxt] = pool.submit(load_batch, nxt)
            yield batch
