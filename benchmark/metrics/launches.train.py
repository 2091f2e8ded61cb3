"""CUDA kernels launched a training step, from the profiler's trace."""

from benchmark.harness.readers import launches


def read(ctx):
    return launches(ctx)
