"""Process groups: the counterpart of `diffusiondrive_tpu/parallel/distributed.py`.

The JAX package reaches several hosts through `jax.distributed.initialize()`,
after which one program spans every device. The port trains with one
process per card under `torch.distributed` (NCCL for CUDA, gloo for the
CPU): `initialize_distributed` joins the group from explicit arguments or
from `torchrun`'s environment, and `launch` starts the ranks itself (the
`spawn` start method: a process forked after CUDA is initialised cannot
use it) and fails as a whole when any rank fails or the time runs out.

Under a group of more than one rank, the two global reductions of a train
step, the BatchNorm statistics (`models/layers.py:BatchNorm2d`) and the
detection loss's count of valid agents (`training/losses.py`), reduce over
the group: every rank must run them together, as every device runs a
sharded JAX program.
"""

from __future__ import annotations

import logging
import os
import pickle
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def world_size() -> int:
    """The size of the default process group, 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group, 0 without one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def backend_for(device: Optional[Union[str, torch.device]]) -> str:
    """NCCL for CUDA (the default device), gloo for the CPU."""
    return "gloo" if device is not None and torch.device(device).type == "cpu" else "nccl"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
    backend: Optional[str] = None,
) -> Tuple[int, int]:
    """Join the default process group when this run has several processes.

    Explicit arguments win (`coordinator_address` "host:port", or any URL
    such as ``file:///path`` for a `FileStore`); otherwise `torchrun`'s
    environment (`WORLD_SIZE`, `RANK`, `MASTER_ADDR`, `MASTER_PORT`) is
    read. One process and no coordinator: nothing happens. The backend is
    NCCL unless `device` is the CPU (gloo) or `backend` says otherwise.
    Returns (rank, world_size).
    """
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    world = int(num_processes) if num_processes is not None else env_world
    rank_ = int(process_id) if process_id is not None else int(os.environ.get("RANK", "0"))
    if not coordinator_address and world <= 1:
        return 0, 1
    backend = backend or backend_for(device)
    if coordinator_address:
        url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        dist.init_process_group(backend=backend, init_method=url, world_size=world, rank=rank_)
    else:
        dist.init_process_group(backend=backend, init_method="env://")
    logger.info("distributed: rank %d/%d (%s)", rank_, world, backend)
    return rank_, world


def host_shard_info() -> Tuple[int, int]:
    """(host_id, num_hosts) for token/log sharding: `HOST_ID` / `NUM_HOSTS`
    first, else the process group's rank and size."""
    host_id = int(os.environ.get("HOST_ID", rank()))
    num_hosts = int(os.environ.get("NUM_HOSTS", world_size()))
    return host_id, num_hosts


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the gradient of each rank's input is the sum of
    every rank's output gradient (each rank's output depends on all inputs)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        out = grad.clone()
        dist.all_reduce(out)
        return out


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """A differentiable sum of `x` over the default process group."""
    return _AllReduceSum.apply(x)


def all_reduce_mean(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Scalars averaged over the process group in one all-reduce of their
    stack (on CUDA it is queued on the stream: no host sync). Without a
    group of more than one rank the values come back as they are."""
    if world_size() <= 1 or not values:
        return values
    keys = list(values)
    dtype = torch.promote_types(torch.float32, values[keys[0]].dtype)
    stacked = torch.stack([values[k].detach().to(dtype) for k in keys])
    dist.all_reduce(stacked)
    stacked /= world_size()
    return {k: stacked[i] for i, k in enumerate(keys)}


def free_tcp_address() -> str:
    """``tcp://127.0.0.1:<port>`` on a port free at the time of the call."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def _rank_device(device: Union[str, torch.device], rank_: int) -> torch.device:
    """A rank's device: ``"cuda"`` (no index) is card `rank_`; an indexed
    device (``"cuda:0"``) or the CPU is the same for every rank."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank_)
    return device


def _math_switches() -> Dict[str, Any]:
    """This process's float32 math switches (TF32 for matmuls and cuDNN)."""
    return {"matmul_tf32": torch.backends.cuda.matmul.allow_tf32, "cudnn_tf32": torch.backends.cudnn.allow_tf32}


def _rank_main(fn: Callable, rank_: int, world: int, init_method: str, device: str,
               backend: Optional[str], threads: Optional[int], switches: Dict[str, Any], args: Sequence[Any],
               results) -> None:
    """A spawned rank: take the parent's math switches, join the group, run
    `fn(rank, world, device, *args)`, report (rank, ok, result or
    traceback), leave the group."""
    try:
        torch.backends.cuda.matmul.allow_tf32 = switches["matmul_tf32"]
        torch.backends.cudnn.allow_tf32 = switches["cudnn_tf32"]
        if threads:
            torch.set_num_threads(threads)
        dev = _rank_device(device, rank_)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        initialize_distributed(init_method, world, rank_, device=dev, backend=backend)
        out = fn(rank_, world, dev, *args)
        dist.barrier()
        dist.destroy_process_group()
        # pickled by value: a tensor sent through the queue as itself would
        # be shared memory, gone when this process exits
        results.put((rank_, True, pickle.dumps(out)))
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank_, False, traceback.format_exc()))
        raise


def launch(fn: Callable, world: int, args: Sequence[Any] = (), device: Union[str, torch.device] = "cuda",
           init_method: Optional[str] = None, backend: Optional[str] = None,
           timeout: Optional[float] = None, threads: Optional[int] = None) -> List[Any]:
    """Run `fn(rank, world, device, *args)` in `world` spawned processes
    joined in one group; returns each rank's result, in rank order.

    `fn` must be importable by name (a module-level function) and its
    result picklable; each rank takes this process's TF32 switches. `device` "cuda" gives rank r card r (NCCL); an
    indexed card ("cuda:0") puts every rank there, which NCCL refuses for
    two ranks, so pass ``backend="gloo"``; "cpu" runs gloo ranks. The
    rendezvous is `init_method` (``file:///path`` for a `FileStore`),
    else a free localhost port. Card ranks find every kernel built: this
    process builds what is missing before it spawns them. If a rank fails,
    or `timeout` seconds pass before every rank has reported, every rank
    still running is killed and this raises: there is no run with fewer
    ranks.
    """
    import torch.multiprocessing as mp

    if torch.device(device).type == "cuda":
        from diffusiondrive_torch.ops._build import build_all

        build_all()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_method = init_method or free_tcp_address()
    switches = _math_switches()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, init_method, str(device), backend, threads,
                                                  switches, tuple(args), results)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    got: Dict[int, Any] = {}
    failure = None
    try:
        while len(got) < world and failure is None:
            try:
                r, ok, payload = results.get(timeout=0.5)
            except queue_mod.Empty:
                dead = [i for i, p in enumerate(procs) if p.exitcode not in (None, 0) and i not in got]
                if dead:
                    failure = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
                elif deadline is not None and time.monotonic() > deadline:
                    failure = f"timed out after {timeout} s with ranks {sorted(got)} done of {world}"
                continue
            if ok:
                got[r] = pickle.loads(payload)
            else:
                failure = f"rank {r} failed:\n{payload}"
        for p in procs:
            if failure is None:
                p.join(timeout=None if deadline is None else max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    if failure is not None:
        raise RuntimeError(f"launch({getattr(fn, '__name__', fn)}, world={world}): {failure}")
    return [got[r] for r in range(world)]
