"""CUDA kernels launched a predict call, from the profiler's trace."""

from benchmark.harness.readers import launches


def read(ctx):
    return launches(ctx)
