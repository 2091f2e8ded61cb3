"""Feature/target datasets and their cache (counterpart of `diffusiondrive_tpu/training/dataset.py`).

A cache holds per-token directories ``<cache>/<log>/<token>/<builder>.gz``,
each a gzip pickle of one builder's numpy dict, the JAX package's format:
the same cache directory yields the same batches, in the same order, in
both packages. The scene-backed `Dataset` computes the features and
targets from OpenScene logs (sensors read from disk) and, given a cache
path, writes the cache on a thread pool, resumably: a token's file is
written only when it is missing, or always with `force_cache_computation`.
`CacheOnlyDataset` trains from a cache alone. `batch_iterator` collates
numpy batches on host threads; the trainer copies each batch to the device.
"""

from __future__ import annotations

import gzip
import pickle
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from diffusiondrive_torch.common.dataloader import SceneLoader
from diffusiondrive_torch.parallel.mesh import rank_rows
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


def load_token(token_dir: Path, feature_builders: List[AbstractFeatureBuilder],
               target_builders: List[AbstractTargetBuilder]) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """One token's cached (features, targets)."""
    features: Dict[str, np.ndarray] = {}
    targets: Dict[str, np.ndarray] = {}
    for b in feature_builders:
        features.update(load_feature_target(token_dir / f"{b.get_unique_name()}.gz"))
    for b in target_builders:
        targets.update(load_feature_target(token_dir / f"{b.get_unique_name()}.gz"))
    return features, targets


class Dataset:
    """Scene-backed dataset with an optional, resumable disk cache."""

    def __init__(self, scene_loader: SceneLoader, feature_builders: List[AbstractFeatureBuilder],
                 target_builders: List[AbstractTargetBuilder], cache_path: Optional[str] = None,
                 force_cache_computation: bool = False, num_workers: int = 8):
        self._scene_loader = scene_loader
        self._feature_builders = feature_builders
        self._target_builders = target_builders
        self._cache_path = Path(cache_path) if cache_path else None
        self._force = force_cache_computation
        if self._cache_path is not None:
            self.cache_dataset(num_workers)

    def __len__(self) -> int:
        return len(self._scene_loader)

    def _token_dir(self, token: str) -> Path:
        log_name = self._scene_loader.scene_frames_dicts[token][0]["log_name"]
        return self._cache_path / log_name / token

    def _cache_token(self, token: str) -> None:
        token_dir = self._token_dir(token)
        token_dir.mkdir(parents=True, exist_ok=True)
        builders = list(self._feature_builders) + list(self._target_builders)
        missing = [b for b in builders
                   if self._force or not (token_dir / f"{b.get_unique_name()}.gz").exists()]
        if not missing:
            return
        scene = self._scene_loader.get_scene_from_token(token)
        agent_input = scene.get_agent_input()
        for builder in missing:
            if isinstance(builder, AbstractFeatureBuilder):
                data = builder.compute_features(agent_input)
            else:
                data = builder.compute_targets(scene)
            dump_feature_target(data, token_dir / f"{builder.get_unique_name()}.gz")

    def cache_dataset(self, num_workers: int = 8) -> None:
        """Compute the missing feature and target files of every token."""
        if self._cache_path is None:
            raise ValueError("cache_dataset needs a cache_path")
        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            list(pool.map(self._cache_token, self._scene_loader.tokens))

    def __getitem__(self, idx: int) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        token = self._scene_loader.tokens[idx]
        if self._cache_path is not None:
            return load_token(self._token_dir(token), self._feature_builders, self._target_builders)
        features: Dict[str, np.ndarray] = {}
        targets: Dict[str, np.ndarray] = {}
        scene = self._scene_loader.get_scene_from_token(token)
        agent_input = scene.get_agent_input()
        for b in self._feature_builders:
            features.update(b.compute_features(agent_input))
        for b in self._target_builders:
            targets.update(b.compute_targets(scene))
        return features, targets


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
        return load_token(self._token_dirs[idx], self._feature_builders, self._target_builders)


def collate(samples: List[Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]]) -> Dict[str, np.ndarray]:
    """Stack feature and target dicts into one flat batch dict."""
    batch: Dict[str, np.ndarray] = {}
    for part in (0, 1):
        for k in samples[0][part]:
            batch[k] = np.stack([np.asarray(s[part][k]) for s in samples])
    return batch


def batch_iterator(dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                   drop_last: bool = True, num_workers: int = 8, rank: int = 0,
                   world_size: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    """Threaded batch loader: the gzip reads of the next batches overlap the
    device's work on the current one (4 batches ahead).

    Data-parallel: `batch_size` is the global batch; every rank follows the
    same order (the seed is shared) and loads only its rows of each batch,
    ``[rank * b, (rank + 1) * b)`` with ``b = batch_size / world_size``. A
    batch that the world size does not divide raises.
    """
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    num_batches = len(order) // batch_size if drop_last else -(-len(order) // batch_size)
    if world_size > 1:
        last = batch_size if drop_last or not num_batches else len(order) - (num_batches - 1) * batch_size
        sizes = {batch_size, last}
        if any(size % world_size for size in sizes):
            raise ValueError(f"a global batch of {sorted(sizes)} rows does not split over {world_size} ranks")

    def load_batch(b: int) -> Dict[str, np.ndarray]:
        idxs = order[b * batch_size:(b + 1) * batch_size]
        if world_size > 1:
            idxs = idxs[rank_rows(len(idxs), rank, world_size)]
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
