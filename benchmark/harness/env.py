"""The run's environment: compile caches at fixed paths inside the checkout,
and the check that no JAX module was loaded."""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "diffusiondrive_tpu")
CACHE = Path(__file__).resolve().parent.parent / ".cache"


def prepare() -> None:
    """Point every compile cache a run may fill at a fixed directory under
    `benchmark/.cache/` (the program's nvcc libraries live at their own fixed
    path, `diffusiondrive_torch/_build/`)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's, Flax's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN)
