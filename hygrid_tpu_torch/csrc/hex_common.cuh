// Shared by the hex conv kernels: the per-parity tap table passed by value
// as a kernel parameter, and float32 loads and stores of the working dtypes.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace hg {

constexpr int kMaxTaps = 64;

// For output-row parity q and flat tap t, output pixel (o, j) reads input
// (o + dr[q][t], j + dc[q][t]), zero outside the image.
struct TapTable {
  int dr[2][kMaxTaps];
  int dc[2][kMaxTaps];
};

// taps_host: (2, kn, 2) int32, as nn/functional.py::hex_tap_table builds it.
inline TapTable make_tap_table(const int* taps_host, int kn) {
  TapTable table{};
  for (int q = 0; q < 2; ++q)
    for (int t = 0; t < kn; ++t) {
      table.dr[q][t] = taps_host[(q * kn + t) * 2];
      table.dc[q][t] = taps_host[(q * kn + t) * 2 + 1];
    }
  return table;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

}  // namespace hg
