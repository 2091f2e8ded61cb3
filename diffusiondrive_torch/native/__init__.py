"""The data loader's native host code, built at first use (see `_native.cpp`).

The port's copy of `diffusiondrive_tpu/native/`. The first call compiles
`_native.cpp` with g++ into ``_build/native-<hash>.so`` (keyed by the
source and the flags, beside the CUDA libraries of `ops/_build.py`) and
loads it with `ctypes`; nothing is built at import. When no compiler is
there or the build fails, it warns once and every function returns
None, so callers take their pure-Python versions, as in JAX.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from diffusiondrive_torch.ops._build import BUILD_DIR

logger = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native.cpp")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_attempted = False


def _target():
    with open(_SRC, "rb") as fp:
        h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + fp.read())
    return BUILD_DIR / f"native-{h.hexdigest()[:16]}.so"


def _build(target) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, _SRC, "-o", str(tmp)], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, target)
        return True
    except Exception as exc:  # noqa: BLE001 — no compiler: the callers' Python versions run
        tmp.unlink(missing_ok=True)
        logger.warning("native extension build failed (%s); using python fallbacks", exc)
        return False


def get_native() -> Optional[ctypes.CDLL]:
    """The loaded library (built on the first call), or None when it cannot
    be built."""
    global _lib, _build_attempted
    with _lock:
        if _lib is not None:
            return _lib
        target = _target()
        if not target.exists():
            if _build_attempted:
                return None
            _build_attempted = True
            if not _build(target):
                return None
        lib = ctypes.CDLL(str(target))
        lib.lzf_decompress.restype = ctypes.c_long
        lib.lzf_decompress.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long]
        lib.histogram2d.restype = None
        lib.histogram2d.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_double,
                                    ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int,
                                    ctypes.c_void_p]
        _lib = lib
        return _lib


def lzf_decompress(data: bytes, expected_size: int) -> Optional[bytes]:
    """Native LZF decompression; None when the library is unavailable.
    A corrupt stream raises ValueError."""
    lib = get_native()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(max(int(expected_size), 1))
    produced = lib.lzf_decompress(bytes(data), len(data), out, int(expected_size))
    if produced < 0:
        raise ValueError("corrupt LZF stream")
    return out.raw[:produced]


def histogram2d(x: np.ndarray, y: np.ndarray, min_x: float, max_x: float, min_y: float, max_y: float,
                bins: int) -> Optional[np.ndarray]:
    """Native 2D histogram (np.histogramdd's regular-grid semantics) as
    (bins, bins) uint32; None when the library is unavailable."""
    lib = get_native()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    y = np.ascontiguousarray(y, np.float32)
    if x.size != y.size:
        raise ValueError("x/y length mismatch")
    hist = np.empty((bins, bins), np.uint32)
    lib.histogram2d(x.ctypes.data, y.ctypes.data, x.size, float(min_x), float(max_x), float(min_y),
                    float(max_y), int(bins), hist.ctypes.data)
    return hist
