"""Build the port's CUDA kernels with `nvcc` at first use, never at import.

Each `csrc/<name>.cu` has a plain C interface and becomes its own shared
library, `_build/<name>-<hash>.so`, keyed by a hash of the sources and the
flags, and loaded with `ctypes`. A source that includes no PyTorch header
builds in seconds, against minutes for `torch.utils.cpp_extension.load`.
`build_all()` starts one `nvcc` per source in `csrc/` at once and waits for
all. Each build's compiler log (ptxas registers and spills) is kept beside
its library, `build_log(name)`.

Without `nvcc` (no CUDA toolkit) a build raises: the kernels are reached
only from CUDA tensors, and a CUDA tensor reaches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# --split-compile=0: the device code's optimisation and ptxas run on every core
# (halves the build of the attention source, which holds 24 kernel instances)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if home.exists():
        return str(home)
    raise RuntimeError("nvcc not found (no CUDA toolkit on PATH or under CUDA_HOME): "
                       "cannot build the diffusiondrive_torch CUDA kernels")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, target: Path) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.tmp, proc.target, proc.kname = tmp, target, name
    return proc


def _finish(proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        proc.tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {proc.kname}.cu (exit {proc.returncode}):\n{log}")
    proc.target.with_suffix(".log").write_text(log)
    os.replace(proc.tmp, proc.target)
    return log


def kernel_names() -> List[str]:
    """Every kernel source of the package: the stems of `csrc/*.cu`."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(names: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Build every named kernel library (default: every `csrc/*.cu`) that is
    not built yet, one `nvcc` per source, all started together. Returns each
    new build's compiler log."""
    names = kernel_names() if names is None else names
    with _lock:
        procs = [_start(n, _target(n)) for n in names if not _target(n).exists()]
        try:
            return {p.kname: _finish(p) for p in procs}
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


def build_log(name: str) -> str:
    """The compiler log of the current build of `csrc/<name>.cu` ("" if it
    is not built)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]
