"""Host-side worker pools: the share-nothing fan-out abstraction.

Copy of `diffusiondrive_tpu/parallel/worker_pool.py` (it imports no JAX).

Parity: `navsim/planning/utils/multithreading/worker_ray_no_torch.py` and the
worker config group (`sequential.yaml`, `single_machine_thread_pool.yaml`,
`ray_distributed_no_torch.yaml`). Ray's role collapses here: intra-host
parallelism is a thread/process pool feeding the device's batch dimension;
inter-host scale is deterministic token sharding over hosts
(`HOST_ID`/`NUM_HOSTS`, see `evaluate/runner.shard_tokens_for_host`).

`worker_map(worker, fn, items)` mirrors nuplan's API so callers are
pool-agnostic; `Sequential` doubles as the serial debug mode
(`debug_mode: true` parity).
"""

from __future__ import annotations

import logging
from abc import ABC, abstractmethod
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Any, Callable, List, Sequence

logger = logging.getLogger(__name__)


class WorkerPool(ABC):
    """Maps a function over work items, flattening list results."""

    @abstractmethod
    def map(self, fn: Callable[[Any], Any], items: Sequence[Any]) -> List[Any]:
        ...


class Sequential(WorkerPool):
    """Serial execution — the debug-mode worker."""

    def map(self, fn, items):
        return [fn(item) for item in items]


class ThreadPool(WorkerPool):
    """Threaded fan-out; right for IO-bound per-token work (numpy and torch
    release the GIL on the heavy parts)."""

    def __init__(self, max_workers: int = 16):
        self._max_workers = max_workers

    def map(self, fn, items):
        with ThreadPoolExecutor(max_workers=self._max_workers) as pool:
            return list(pool.map(fn, items))


class ProcessPool(WorkerPool):
    """Process fan-out for CPU-bound host work (fn/items must pickle).

    NOTE: do not initialize CUDA before forking; use for pure-host stages
    (metric caching without device scoring, dataset caching)."""

    def __init__(self, max_workers: int = 8):
        self._max_workers = max_workers

    def map(self, fn, items):
        with ProcessPoolExecutor(max_workers=self._max_workers) as pool:
            return list(pool.map(fn, items))


def worker_map(worker: WorkerPool, fn: Callable[[Any], List[Any]], items: Sequence[Any]) -> List[Any]:
    """nuplan-style worker_map: apply fn to each item, concatenate list results."""
    results: List[Any] = []
    for out in worker.map(fn, items):
        if isinstance(out, list):
            results.extend(out)
        else:
            results.append(out)
    return results


def build_worker(name: str = "thread_pool", **kwargs) -> WorkerPool:
    """Config-string worker factory (`script/builders/worker_pool_builder.py` parity)."""
    pools = {"sequential": Sequential, "thread_pool": ThreadPool, "process_pool": ProcessPool}
    if name not in pools:
        raise KeyError(f"Unknown worker '{name}'. Available: {sorted(pools)}")
    return pools[name](**kwargs)
