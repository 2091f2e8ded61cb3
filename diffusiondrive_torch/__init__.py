"""PyTorch/CUDA port of DiffusionDrive for NVIDIA Hopper (H100).

A package of its own beside the JAX reference package `diffusiondrive_tpu`;
module paths mirror it so each module's counterpart is found at the same
relative path. It imports `torch` and numpy only — never `jax`, `flax` or
anything of the JAX package.

Slice covered: the planner forward in eval mode (`entry.py`,
`models/transfuser_model.py:DiffusionDriveModel`). Its two hand-written CUDA
kernels (`csrc/stem_fused.cu`, `csrc/conv3x3_fused.cu`) are built with
`nvcc` on first use (`ops/_build.py`), never at import.
"""

__version__ = "0.1.0"
