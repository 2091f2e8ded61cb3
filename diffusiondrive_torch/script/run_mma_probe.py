"""What one SM's mma.sync delivers, without a kernel's loads: the ceiling of the tensor-core kernels.

Each of 8 warps a block, one block an SM, issues 16 independent mma.sync
products an iteration (`csrc/mma.cuh`'s `mma_tf32`, `mma_bf16`): TF32
m16n8k8 alone; TF32 with the 3xTF32 split's ALU between products at the
conv3x3 and stem kernels' ratio (3 instructions a split value, 8 values for
16 products, as 24 values for 48 products there); and bf16 m16n8k16. Prints
the card's name and power limit, then TFLOP/s and products per ns per SM
for each, against the data sheet's dense peaks (494.7 TF32, 989 bf16).

Example (one GPU; builds with nvcc into `diffusiondrive_torch/_build/`):
    python -m diffusiondrive_torch.script.run_mma_probe
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess

import torch

from diffusiondrive_torch.ops import _build

SOURCE = r"""
#include <cuda_runtime.h>
#include "mma.cuh"
template <int MODE>  // 0: TF32 products; 1: TF32 products and the split's ALU; 2: bf16 products
__global__ void __launch_bounds__(256, 1) probe(float* out, int iters) {
  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
  uint32_t a[4], b0 = __float_as_uint(1.0f + threadIdx.x * 1e-7f), b1 = b0 ^ 1u;
#pragma unroll
  for (int q = 0; q < 4; ++q) a[q] = __float_as_uint(0.5f + q * 1e-3f);
  for (int i = 0; i < iters; ++i) {
    if (MODE == 1) {
      uint32_t ab[4], as[4], bb[2], bs[2];
#pragma unroll
      for (int q = 0; q < 4; ++q) ddt::split_tf32(__uint_as_float(a[q] ^ i), ab[q], as[q]);
      ddt::split_tf32(__uint_as_float(b0 ^ i), bb[0], bs[0]);
      ddt::split_tf32(__uint_as_float(b1 ^ i), bb[1], bs[1]);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint32_t x[4] = {ab[0], ab[1], ab[2], as[j & 3]};
        ddt::mma_tf32(acc[j], x, bb[j & 1], bs[j & 1]);
      }
    } else if (MODE == 0) {
#pragma unroll
      for (int j = 0; j < 16; ++j) ddt::mma_tf32(acc[j], a, b0, b1);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) ddt::mma_bf16(acc[j], a, b0, b1);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) s += acc[j][q];
  if (s == 1234.5f) out[threadIdx.x] = s;  // keeps the products alive
}
extern "C" int run_probe(int mode, void* out, int blocks, int iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (mode == 0) probe<0><<<blocks, 256, 0, s>>>(o, iters);
  if (mode == 1) probe<1><<<blocks, 256, 0, s>>>(o, iters);
  if (mode == 2) probe<2><<<blocks, 256, 0, s>>>(o, iters);
  return (int)cudaGetLastError();
}
"""

MODES = ((0, "tf32 m16n8k8", 2048, 494.7e12), (1, "tf32 m16n8k8 + 3xTF32 split ALU", 2048, 494.7e12),
         (2, "bf16 m16n8k16", 4096, 989e12))
WARPS, PRODUCTS, ITERS = 8, 16, 4096


def _library() -> ctypes.CDLL:
    digest = hashlib.sha256((SOURCE + (_build.CSRC / "mma.cuh").read_text()).encode()).hexdigest()[:16]
    target = _build.BUILD_DIR / f"mma_probe-{digest}.so"
    if not target.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = target.with_suffix(".cu")
        src.write_text(SOURCE)
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(target), str(src)],
                       check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(target))
    lib.run_probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("run_mma_probe: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    lib, dev = _library(), torch.device("cuda", 0)
    out, sms = torch.empty(256, device=dev), torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    for mode, name, flops, peak in MODES:
        launch = lambda: lib.run_probe(mode, out.data_ptr(), sms, ITERS, stream)  # noqa: E731
        if launch() != 0:
            raise RuntimeError(f"run_mma_probe: launch failed ({name})")
        torch.cuda.synchronize()
        runs = []
        for _ in range(3):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(5):
                launch()
            b.record()
            b.synchronize()
            runs.append(a.elapsed_time(b) / 5)
        ms = sorted(runs)[1]
        products = sms * WARPS * ITERS * PRODUCTS
        rate = products * flops / (ms * 1e-3)
        print(json.dumps({"probe": name, "ms": ms, "runs": runs, "tflops": rate / 1e12, "of_peak": rate / peak,
                          "products_per_ns_per_sm": products / sms / (ms * 1e6)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
