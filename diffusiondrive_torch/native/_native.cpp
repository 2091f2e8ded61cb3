// Host hot paths of the data loader, with a plain C interface for ctypes.
//
// The port's copy of `diffusiondrive_tpu/native/_native.cpp`:
//
//  - lzf_decompress: PCD `binary_compressed` payloads (liblzf's format).
//    Orders of magnitude faster than the pure-Python decoder of
//    `common/dataclasses.py`.
//  - histogram2d:    uint32 2D bin counts of float32 points over a regular
//    grid (np.histogramdd's semantics, right edge closed).
//
// Built with g++ at first use by `native/__init__.py` into
// `diffusiondrive_torch/_build/` and loaded with ctypes (which releases the
// GIL for the length of each call).

#include <cstdint>
#include <cstring>

extern "C" {

// Decompress `in` into `out` (capacity `out_cap`). Returns the bytes
// written, or -1 for a corrupt stream.
long lzf_decompress(const uint8_t* in, long in_len, uint8_t* out, long out_cap) {
  long ip = 0, op = 0;
  while (ip < in_len) {
    uint32_t ctrl = in[ip++];
    if (ctrl < 32) {  // literal run of ctrl+1 bytes
      long run = (long)ctrl + 1;
      if (op + run > out_cap || ip + run > in_len) return -1;
      std::memcpy(out + op, in + ip, run);
      ip += run;
      op += run;
    } else {  // back reference
      long len = ctrl >> 5;
      if (len == 7) {
        if (ip >= in_len) return -1;
        len += in[ip++];
      }
      if (ip >= in_len) return -1;
      long ref = op - (((long)(ctrl & 0x1f)) << 8) - in[ip++] - 1;
      if (ref < 0 || op + len + 2 > out_cap) return -1;
      // byte by byte: a reference may overlap its own output
      for (long i = 0; i < len + 2; ++i) out[op++] = out[ref++];
    }
  }
  return op;
}

// Count the n points (x[i], y[i]) into hist (bins x bins, zeroed here),
// row = x bin; points outside [min, max] are skipped.
void histogram2d(const float* x, const float* y, long n, double min_x, double max_x,
                 double min_y, double max_y, int bins, uint32_t* hist) {
  std::memset(hist, 0, (size_t)bins * bins * sizeof(uint32_t));
  const double sx = bins / (max_x - min_x);
  const double sy = bins / (max_y - min_y);
  for (long i = 0; i < n; ++i) {
    const double xv = x[i], yv = y[i];
    if (xv < min_x || xv > max_x || yv < min_y || yv > max_y) continue;
    int ix = (int)((xv - min_x) * sx);
    int iy = (int)((yv - min_y) * sy);
    if (ix >= bins) ix = bins - 1;  // right edge closed
    if (iy >= bins) iy = bins - 1;
    hist[(size_t)ix * bins + iy] += 1;
  }
}

}  // extern "C"
