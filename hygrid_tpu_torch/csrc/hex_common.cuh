// Shared by the hex conv kernels: the per-parity tap table passed by value
// as a kernel parameter, float32 loads and stores of the working dtypes, and
// the conv pass's tile (hex_conv_layer.cu, hex_conv_fused_stack.cu,
// hex_conv_single.cu).
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

// taps_host: (2, kn, 2) int32, as nn/functional.py::hex_tap_table (or
// hex_valid_tap_table) builds it.
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

// ---- the conv pass's tile -------------------------------------------------
//
// One tile is kTileP consecutive output pixels of one output row and COB
// output channels.  The block (kConvThreads threads) stages the input patch
// the taps reach (the rows x (kTileP + tap width) pixels x kChunkC input
// channels) and the matching weights (taps x kChunkC x COB) in shared memory,
// and each thread accumulates a PT pixel x kChanT channel register tile in
// f32.  Patch rows are laid out [row][channel][col] so the threads of a warp
// that share a channel read consecutive words (no bank conflicts); the
// kChanT output channels come as one float4.  Every output accumulates over
// input-channel chunks, then taps, then the chunk's channels, in that order,
// whatever COB and the input layout are: kernels that share this tile agree
// bit for bit.  The tile reads NHWC (channel-fastest staging walk) or NCHW
// (column-fastest walk), so that a warp's loads are consecutive in either
// layout.
constexpr int kTileP = 64;       // output pixels per tile
constexpr int kChunkC = 16;      // input channels per stage
constexpr int kChanT = 4;        // output channels per thread
constexpr int kConvThreads = 128;

template <int COB>
struct ConvTile {
  static constexpr int kPT = kTileP * COB / (kChanT * kConvThreads);  // pixels per thread
  static constexpr int kPixLanes = kTileP / kPT;
  static_assert(kPT * kPixLanes == kTileP &&
                kPixLanes * (COB / kChanT) == kConvThreads, "tile shape");
};

// The patch's extent: rows r_lo .. r_lo + n_rows - 1 around the output row,
// columns c_lo .. c_lo + n_cols - 1 around the tile's first pixel.
struct Geometry {
  TapTable taps;
  int r_lo, n_rows, c_lo, n_cols;
};

inline Geometry make_geometry(const int* taps_host, int kn) {
  Geometry g{};
  g.taps = make_tap_table(taps_host, kn);
  int r_lo = 1 << 30, r_hi = -(1 << 30), c_lo = 1 << 30, c_hi = -(1 << 30);
  for (int q = 0; q < 2; ++q)
    for (int t = 0; t < kn; ++t) {
      const int dr = g.taps.dr[q][t];
      const int dc = g.taps.dc[q][t];
      r_lo = dr < r_lo ? dr : r_lo;
      r_hi = dr > r_hi ? dr : r_hi;
      c_lo = dc < c_lo ? dc : c_lo;
      c_hi = dc > c_hi ? dc : c_hi;
    }
  g.r_lo = r_lo;
  g.n_rows = r_hi - r_lo + 1;
  g.c_lo = c_lo;
  g.n_cols = kTileP + c_hi - c_lo;
  return g;
}

// Shared memory of one tile, in bytes.
inline size_t conv_tile_smem(const Geometry& g, int kn, int cob) {
  return sizeof(float) * ((size_t)g.n_rows * kChunkC * g.n_cols +
                          (size_t)kn * kChunkC * cob);
}

// Accumulate the tile at output row o, pixels w0.., channels co0.. of the
// sample xb ((H, W, Cin), or (Cin, H, W) when kNCHW) into acc.  w: (kn,
// Cin, Cout) float32.  smem holds conv_tile_smem bytes.  With load_w false
// the weights staged by the last call are used again (only valid when
// Cin <= kChunkC and co0 is the same).
//
// kSplit: the input is the channel concatenation of two NHWC samples, xb
// (H, W, Ca) holding channels [0, Ca) and xb2 (H, W, Cin - Ca) the rest;
// the concatenation is never built.  Only the staging load picks its
// source, per element, so a chunk may straddle Ca, and the accumulation
// order is the one over the concatenated channels: the result is bit-equal
// to the unsplit tile on the materialised concatenation.
template <int COB, bool kNCHW = false, bool kSplit = false, typename Tin>
__device__ __forceinline__ void conv_tile(
    const Tin* __restrict__ xb, const float* __restrict__ w, float* smem,
    int H, int W, int Cin, int Cout, int kn, const TapTable& taps, int r_lo,
    int n_rows, int c_lo, int n_cols, int o, int w0, int co0, bool load_w,
    float (&acc)[ConvTile<COB>::kPT][kChanT],
    const Tin* __restrict__ xb2 = nullptr, int Ca = 0) {
  static_assert(!(kSplit && kNCHW), "the split input is NHWC");
  constexpr int PT = ConvTile<COB>::kPT;
  constexpr int kPixLanes = ConvTile<COB>::kPixLanes;
  float* xs = smem;                               // [n_rows][kChunkC][n_cols]
  float* ws = smem + n_rows * kChunkC * n_cols;   // [kn][kChunkC][COB]
  const int q = o & 1;
  const int tid = threadIdx.x;
  const int tp = tid % kPixLanes;
  const int tc = tid / kPixLanes;
#pragma unroll
  for (int i = 0; i < PT; ++i)
#pragma unroll
    for (int j = 0; j < kChanT; ++j) acc[i][j] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += kChunkC) {
    __syncthreads();
    // consecutive threads read consecutive channels (NHWC) or columns (NCHW)
    const int n_x = n_rows * n_cols * kChunkC;
    for (int e = tid; e < n_x; e += kConvThreads) {
      const int ck = kNCHW ? (e / n_cols) % kChunkC : e % kChunkC;
      const int c = kNCHW ? e % n_cols : (e / kChunkC) % n_cols;
      const int r = e / (kChunkC * n_cols);
      const int gi = o + r_lo + r, gj = w0 + c_lo + c, gc = ci0 + ck;
      float v = 0.f;
      if (gi >= 0 && gi < H && gj >= 0 && gj < W && gc < Cin) {
        if constexpr (kSplit) {
          const long long pix = (long long)gi * W + gj;
          v = to_f32(gc < Ca ? xb[pix * Ca + gc]
                             : xb2[pix * (Cin - Ca) + (gc - Ca)]);
        } else {
          v = to_f32(kNCHW ? xb[((long long)gc * H + gi) * W + gj]
                           : xb[((long long)gi * W + gj) * Cin + gc]);
        }
      }
      xs[(r * kChunkC + ck) * n_cols + c] = v;
    }
    if (load_w) {
      const int n_w = kn * kChunkC * COB;
      for (int e = tid; e < n_w; e += kConvThreads) {
        const int co = e % COB;
        const int ck = (e / COB) % kChunkC;
        const int t = e / (COB * kChunkC);
        const int gc = ci0 + ck, gco = co0 + co;
        ws[e] = (gc < Cin && gco < Cout)
                    ? __ldg(w + ((long long)t * Cin + gc) * Cout + gco) : 0.f;
      }
    }
    __syncthreads();
    for (int t = 0; t < kn; ++t) {
      const float* xr = xs + (taps.dr[q][t] - r_lo) * kChunkC * n_cols
                      + (taps.dc[q][t] - c_lo) + tp;
      const float* wr = ws + t * kChunkC * COB + tc * kChanT;
#pragma unroll 4
      for (int ck = 0; ck < kChunkC; ++ck) {
        const float4 wv = *reinterpret_cast<const float4*>(wr + ck * COB);
#pragma unroll
        for (int i = 0; i < PT; ++i) {
          const float xv = xr[ck * n_cols + i * kPixLanes];
          acc[i][0] = fmaf(xv, wv.x, acc[i][0]);
          acc[i][1] = fmaf(xv, wv.y, acc[i][1]);
          acc[i][2] = fmaf(xv, wv.z, acc[i][2]);
          acc[i][3] = fmaf(xv, wv.w, acc[i][3]);
        }
      }
    }
  }
}

}  // namespace hg
