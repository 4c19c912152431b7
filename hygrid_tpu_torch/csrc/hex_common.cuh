// Shared by the hex conv kernels: the per-parity tap table passed by value
// as a kernel parameter, float32 loads and stores of the working dtypes, the
// conv pass's CUDA-core tile (conv_tile: hex_conv_layer.cu and
// hex_conv_fused_stack.cu in float32) and its bf16 tensor-core tile
// (conv_tile_mma: hex_conv_layer.cu in bfloat16; conv_tile_mma_nchw, the
// same tile staged from NCHW input: hex_conv_single.cu in bfloat16;
// hex_conv_fused_stack.cu runs its units, weights and MMAs on row bands),
// and the GN passes' vector loads and stores and thread layout
// (hex_conv_layer.cu, gn_backward.cu).
#pragma once
#include <cstdint>
#include <type_traits>
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

// ---- V consecutive channels of one pixel (the GN passes) -----------------
//
// V = 8 or 4 need the address aligned to V elements of a 16-byte aligned
// tensor (8 bf16 = one 16-byte access, 8 float32 = two); V = 1 is scalar.
template <int V>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x, v[i + 1] = q.y, v[i + 2] = q.z, v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* __restrict__ p,
                                         float (&v)[V]) {
  if constexpr (V % 4 == 0) {
    __align__(16) __nv_bfloat162 h[V / 2];
    if constexpr (V == 8)
      *reinterpret_cast<uint4*>(h) = *reinterpret_cast<const uint4*>(p);
    else
      *reinterpret_cast<uint2*>(h) = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __bfloat162float(p[i]);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* __restrict__ p,
                                          const float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}

template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* __restrict__ p,
                                          const float (&v)[V]) {
  if constexpr (V % 4 == 0) {
    __align__(16) __nv_bfloat162 h[V / 2];
#pragma unroll
    for (int i = 0; i < V / 2; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    if constexpr (V == 8)
      *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
    else
      *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = __float2bfloat16(v[i]);
  }
}

// The thread layout of the GN passes over NHWC (pixels, C): a block of
// cvs x k threads, cvs = C / V vectors a pixel; thread t holds channels
// (t % cvs) V .. + V - 1 for its whole run, pixel rows t / cvs, + k, ...,
// so that no element pays an integer divide.  V: 8 where C % 8 == 0 and
// every tensor is 16-byte aligned, else 4 where C % 4 == 0, else 1.
struct GnLayout {
  int V, cvs, k;
  int threads() const { return cvs * k; }
};

inline GnLayout gn_layout(int C, bool aligned) {
  const int V = aligned && C % 8 == 0 ? 8 : aligned && C % 4 == 0 ? 4 : 1;
  const int cvs = C / V;
  return {V, cvs, cvs >= 256 ? 1 : 256 / cvs};
}

// f(std::integral_constant<int, V>{}) for the layout's V: the launch of a
// GN pass's instantiation.
template <typename F>
int dispatch_v(int V, F&& f) {
  switch (V) {
    case 8:
      return f(std::integral_constant<int, 8>{});
    case 4:
      return f(std::integral_constant<int, 4>{});
    default:
      return f(std::integral_constant<int, 1>{});
  }
}

// ---- the conv pass's CUDA-core tile ---------------------------------------
//
// The float32 conv pass of hex_conv_layer.cu and hex_conv_fused_stack.cu
// (TPU kernels #9, #10 and 10s, the dx of #12 and 12s, and #11, in
// float32; the bfloat16 passes are conv_tile_mma below; hex_conv_single.cu's
// float32 tile is its own and sums in this tile's order).  It replaces the
// Kronecker matmuls of conv_pallas.py's _stack_layer_kernel,
// _stack_layer_kernel_banded and _fused_stack_kernel with full float32
// FMAs on the CUDA cores: TF32 would not hold the 1e-5 agreement with the
// reference.
//
// What bounds it: the FP32 pipes (67 TFLOP/s), so the design keeps them
// fed.  A tile is F32Tile<COB>::kRows consecutive output rows x kTileP = 64
// columns x COB output channels (COB = 16, 32 or 64) on kF32Threads = 256
// threads.  Thread t has a column lane cl = t % 8 and, from t / 8, a channel
// lane tc and a row: it holds kF32Pix = 8 pixels of one row (columns cl,
// cl + 8, ..., cl + 56) x kCT channels (two groups of 4, at 4 tc and
// COB / 2 + 4 tc; one group where COB = 16), 64 (or 32) f32 accumulators.
// A warp is one row's 8 column lanes x 4 channel lanes, so for each (tap,
// channel) step it reads 8 x values (8 distinct words: one wavefront,
// broadcast over the channel lanes) and 2 float4 weights (64 contiguous
// bytes each) for 64 FMAs.
//
// Shared memory (stages of conv_tile_smem bytes): the patch the tile's taps
// reach, rows o0 + r_lo .. o0 + kRows - 1 + r_hi x n_cols columns x 16
// channels of one input chunk, NHWC with each pixel's four 16-byte units
// swizzled (unit g at (g ^ ((col >> 1) & 3))), so that the 8 consecutive
// columns a warp reads for one channel fall in 8 distinct banks and every
// read's offset from the tap's base is a constant; then the chunk's
// weights, [tap][16][COB].  Chunk c + 1 is copied in by cp.async (16 bytes
// a copy where the input's channels come in whole 4-channel units, else 4
// bytes an element, zero-filled outside the image and past Cin or Cout)
// while chunk c multiplies, where two stages fit (conv_tile_plan).  The
// patch grows with the rows the taps reach (2 d + 1 at dilation d); where
// no tile of all the taps fits, a stage holds one group of taps, its rows
// and its weights, and the groups of a chunk follow each other.
//
// Every output accumulates over input-channel chunks of 16, then taps in
// table order, then the chunk's channels, one fmaf each, from 0: the order
// of the K loop, whatever the tile's shape, so kernels that share this
// order agree bit for bit.  Channels past Cin in the last chunk are skipped
// (their products are +0, and a sum that starts at +0 is never -0, so
// skipping them changes no bit).
constexpr int kTileP = 64;       // output columns of a tile row
constexpr int kChunkC = 16;      // input channels per stage
constexpr int kConvThreads = 128;   // the bf16 tile: one warpgroup
constexpr int kF32Threads = 256;    // the float32 tile
constexpr int kF32Pix = 8;          // pixels a thread, 8 columns apart
constexpr int kMmaMaxSmem = 232448;  // shared memory a block may use (H100)

template <int COB>
struct F32Tile {
  static_assert(COB == 16 || COB == 32 || COB == 64, "the tile's widths");
  static constexpr int kCT = COB >= 32 ? 8 : 4;   // channels a thread
  static constexpr int kCL = COB / kCT;           // channel lanes: 4 or 8
  static constexpr int kRows = 32 / kCL;          // output rows: 8 or 4
  static_assert(kRows * kTileP * COB == kF32Threads * kF32Pix * kCT,
                "tile shape");
};

__host__ __device__ constexpr int f32_tile_rows(int cob) {
  return cob == 64 ? 4 : 8;
}

// The patch's extent: rows r_lo .. r_lo + n_rows - 1 around an output row,
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

// The patch rows the bf16 tiles stage (conv_tile_mma; hex_conv_wgrad.cu's
// tensor-core pass): only the rows some tap reads, in order, so that patch
// row k is input row o + dr[k] around output row o.  A dilated kernel reads
// few of the rows its taps span (radius 2 at dilation d: rows -d, 0 and d
// of 2 d + 1), and its patch shrinks to those; a table whose taps read
// every row between their first and last (dilation 1) keeps the patch of
// all of them, row k at r_lo + k, unchanged.
struct RowMap {
  int dr[kMaxTaps];
};

// The geometry of the staged rows alone: g with each tap's row offset
// replaced by its patch row (so r_lo = 0 and n_rows the rows read), the
// input row of each patch row in *rows.
inline Geometry compact_rows(const Geometry& g, int kn, RowMap* rows) {
  Geometry c = g;
  int n = 0;
  for (int r = g.r_lo; r < g.r_lo + g.n_rows; ++r) {
    bool read = false;
    for (int q = 0; q < 2; ++q)
      for (int t = 0; t < kn; ++t) read = read || g.taps.dr[q][t] == r;
    if (read) rows->dr[n++] = r;
  }
  for (int q = 0; q < 2; ++q)
    for (int t = 0; t < kn; ++t)
      for (int k = 0; k < n; ++k)
        if (rows->dr[k] == g.taps.dr[q][t]) c.taps.dr[q][t] = k;
  c.r_lo = 0;
  c.n_rows = n;
  return c;
}

// The rows a group of taps t0 .. t1 - 1 reaches at either parity: its
// first row (returned) and their count (in *rows).
__host__ __device__ inline int tap_band(const TapTable& taps, int t0, int t1,
                                        int* rows) {
  int lo = 1 << 30, hi = -(1 << 30);
  for (int t = t0; t < t1; ++t)
    for (int q = 0; q < 2; ++q) {
      lo = taps.dr[q][t] < lo ? taps.dr[q][t] : lo;
      hi = taps.dr[q][t] > hi ? taps.dr[q][t] : hi;
    }
  *rows = hi - lo + 1;
  return lo;
}

// The most rows one group reaches where the kn taps go in groups of tg
// (taps [0, tg), [tg, 2 tg), ...).
inline int tap_band_rows(const TapTable& taps, int kn, int tg) {
  int most = 0;
  for (int t0 = 0; t0 < kn; t0 += tg) {
    int rows;
    tap_band(taps, t0, t0 + tg < kn ? t0 + tg : kn, &rows);
    most = rows > most ? rows : most;
  }
  return most;
}

// Shared memory of the float32 tile, in bytes: `stages` copies of one
// chunk's patch for a group of tg taps reaching band rows (the tile's rows
// + band - 1 rows x n_cols columns) and the group's weights.
inline size_t conv_tile_smem(int band, int n_cols, int tg, int cob,
                             int stages) {
  return sizeof(float) * stages *
         ((size_t)(f32_tile_rows(cob) + band - 1) * n_cols * kChunkC +
          (size_t)tg * kChunkC * cob);
}

struct F32Plan {
  int cob, rows, stages;
  int taps, band;   // taps a group (kn: one group) and the most rows one reaches
  size_t smem;
};

// The float32 tile for a layer: COB the least of 16, 32, 64 that covers
// Cout (64 above); two stages where Cin spans more than one chunk; while
// that does not fit in a block's shared memory, one stage, then half the
// channels.  Where no tile of all kn taps fits (a wide dilation: the patch
// grows with the rows the taps reach), the taps go in groups, the most a
// group that fit, each group a stage of its own (its rows and weights):
// the same order of products.  cob = 0: nothing fits.
// kernels/conv_stack.py::_f32_tile mirrors it.
inline F32Plan conv_tile_plan(const Geometry& g, int kn, int cin, int cout) {
  for (int tg = kn; tg >= 1; --tg) {
    const int band = tg == kn ? g.n_rows : tap_band_rows(g.taps, kn, tg);
    for (int cob = cout <= 16 ? 16 : cout <= 32 ? 32 : 64; cob >= 16;
         cob /= 2)
      for (int stages = cin > kChunkC ? 2 : 1; stages >= 1; --stages) {
        const size_t smem = conv_tile_smem(band, g.n_cols, tg, cob, stages);
        if (smem <= (size_t)kMmaMaxSmem)
          return {cob, f32_tile_rows(cob), stages, tg, band, smem};
      }
  }
  return {0, 0, 0, 0, 0, 0};
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// The swizzled float offset of channel ck of patch pixel p (column c).
__device__ __forceinline__ int f32_patch_at(int p, int c, int ck) {
  return p * kChunkC + ((((ck >> 2) ^ (c >> 1)) & 3) << 2) + (ck & 3);
}

// The float32 tile's copy flags (hex_conv_layer.cu packs them into its
// `vec` argument): 16-byte copies of the input and of the weights, 16-byte
// stores of the output, two stages.
constexpr int kF32VecX = 1, kF32VecW = 2, kF32VecOut = 4, kF32TwoStages = 8;

// One step's patch (input channels ci0 .. ci0 + kc - 1, kc = min(16, Cin -
// ci0), rows r_lo .. r_lo + n_prow - 1 around the tile's first row) into
// buf, and with load_w the weights of its nt taps from tap t0 (output
// channels co0 .. co0 + COB - 1) into ws, by cp.async; the caller commits.
// A chunk of fewer than 16 channels stages only its own (the multiply
// reads no others).
template <int COB, bool kSplit>
__device__ __forceinline__ void conv_tile_stage(
    float* buf, float* ws, const float* __restrict__ xb,
    const float* __restrict__ xb2, int Ca, const float* __restrict__ w,
    int H, int W, int Cin, int Cout, int r_lo, int n_prow, int c_lo,
    int n_cols, int o0, int w0, int co0, int ci0, int t0, int nt,
    bool load_w, int flags) {
  const int kc = min(kChunkC, Cin - ci0);
  const int tid = threadIdx.x;
  auto src_of = [&](int gi, int gj, int gc) -> const float* {
    const long long pix = (long long)gi * W + gj;
    if constexpr (kSplit)
      return gc < Ca ? xb + pix * Ca + gc : xb2 + pix * (Cin - Ca) + (gc - Ca);
    else
      return xb + pix * Cin + gc;
  };
  if (flags & kF32VecX) {
    // 4-channel units, consecutive threads on a pixel's four units
    const int g = tid & 3, gc = ci0 + 4 * g;
    int p = tid >> 2;
    int r = p / n_cols, c = p - r * n_cols;
    if (4 * g >= kc) r = n_prow;   // past the chunk's channels
    for (; r < n_prow; p += kF32Threads / 4) {
      const int gi = o0 + r_lo + r, gj = w0 + c_lo + c;
      const bool live = gi >= 0 && gi < H && gj >= 0 && gj < W && gc < Cin;
      cp_async16(buf + p * kChunkC + (((g ^ (c >> 1)) & 3) << 2),
                 live ? src_of(gi, gj, gc) : xb, live ? 16 : 0);
      c += kF32Threads / 4;
      if (c >= n_cols) {
        c -= n_cols;
        ++r;
      }
    }
  } else {
    // element by element, the kc channels of each pixel (the 3-channel
    // stem; Cin or the split's Ca not a multiple of 4; an unaligned input)
    for (int e = tid; e < n_prow * n_cols * kc; e += kF32Threads) {
      const int ck = e % kc, p = e / kc;
      const int r = p / n_cols, c = p - r * n_cols;
      const int gi = o0 + r_lo + r, gj = w0 + c_lo + c;
      const bool live = gi >= 0 && gi < H && gj >= 0 && gj < W;
      cp_async4(buf + f32_patch_at(p, c, ck),
                live ? src_of(gi, gj, ci0 + ck) : xb, live ? 4 : 0);
    }
  }
  if (!load_w) return;
  // [tap][16][COB], the rows of the chunk's kc channels
  if (flags & kF32VecW) {
    constexpr int U = COB / 4;
    for (int e = tid; e < nt * kc * U; e += kF32Threads) {
      const int row = e / U, co = co0 + 4 * (e % U);
      const int t = row / kc, ck = row - t * kc;
      const bool live = co < Cout;
      cp_async16(
          ws + (t * kChunkC + ck) * COB + 4 * (e % U),
          live ? w + ((long long)(t0 + t) * Cin + ci0 + ck) * Cout + co : w,
          live ? 16 : 0);
    }
  } else {
    for (int e = tid; e < nt * kc * COB; e += kF32Threads) {
      const int row = e / COB, co = co0 + e % COB;
      const int t = row / kc, ck = row - t * kc;
      const bool live = co < Cout;
      cp_async4(
          ws + (t * kChunkC + ck) * COB + e % COB,
          live ? w + ((long long)(t0 + t) * Cin + ci0 + ck) * Cout + co : w,
          live ? 4 : 0);
    }
  }
}

// A thread's operands of one (tap, channel) step: 8 x values (columns 8
// apart, at xp[128 i]) and its kCT weights (float4s at wp and wp + COB / 2).
template <int COB>
struct ConvFrag {
  float x[kF32Pix];
  float w[F32Tile<COB>::kCT];

  __device__ __forceinline__ void load(const float* xp, const float* wp) {
#pragma unroll
    for (int h = 0; h < F32Tile<COB>::kCT / 4; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(wp + h * (COB / 2));
      w[4 * h] = v.x, w[4 * h + 1] = v.y, w[4 * h + 2] = v.z,
      w[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < kF32Pix; ++i) x[i] = xp[8 * kChunkC * i];
  }

  __device__ __forceinline__ void fma(
      float (&acc)[kF32Pix][F32Tile<COB>::kCT]) const {
#pragma unroll
    for (int i = 0; i < kF32Pix; ++i)
#pragma unroll
      for (int j = 0; j < F32Tile<COB>::kCT; ++j)
        acc[i][j] = fmaf(x[i], w[j], acc[i][j]);
  }
};

// Accumulate the tile at output rows o0 .. o0 + kRows - 1, columns w0 ..
// w0 + 63, channels co0 .. co0 + COB - 1 of the NHWC sample xb (H, W, Cin)
// into acc: thread t's pixels are row o0 + (t / 8) / kCL, columns w0 + t % 8
// + 8 i, its channels co0 + h COB / 2 + 4 ((t / 8) % kCL) + j.  w: (kn,
// Cin, Cout) float32.  kGroups: the taps go in groups of tg
// (conv_tile_plan), and a step stages one chunk's patch for one group:
// steps run chunk by chunk, a chunk's groups in table order, so the order
// of the products is the same for every tg.  Without kGroups a step is a
// chunk of all kn taps (tg = kn) and rows r_lo .. r_lo + n_rows - 1; with
// it, n_rows is the most rows one group reaches (F32Plan::band).  smem
// holds conv_tile_smem(.., stages) bytes, 16-byte aligned; flags: kF32VecX
// (every 4-channel unit of the input lies whole in one 16-byte aligned
// input), kF32VecW (the same for the weights), the stages
// (kF32TwoStages).  With load_w false the weights the last call staged are
// used again (only where Cin <= kChunkC, without kGroups, and co0 is the
// same).
// Ends on a barrier, so the caller may reuse smem.
//
// kSplit: the input is the channel concatenation of two NHWC samples, xb
// (H, W, Ca) holding channels [0, Ca) and xb2 (H, W, Cin - Ca) the rest;
// the concatenation is never built.  Only the copies pick their source
// (per 4-channel unit, or per element where Ca is not a multiple of 4), so
// the result is bit-equal to the unsplit tile on the concatenation.
template <int COB, bool kSplit = false, bool kGroups = false>
__device__ __forceinline__ void conv_tile(
    const float* __restrict__ xb, const float* __restrict__ w, float* smem,
    int H, int W, int Cin, int Cout, int kn, int tg, const TapTable& taps,
    int r_lo, int n_rows, int c_lo, int n_cols, int o0, int w0, int co0,
    bool load_w, int flags, float (&acc)[kF32Pix][F32Tile<COB>::kCT],
    const float* __restrict__ xb2 = nullptr, int Ca = 0) {
  using T = F32Tile<COB>;
  const int n_prow = T::kRows + n_rows - 1;
  const int patch_floats = n_prow * n_cols * kChunkC;
  const int stage_floats = patch_floats + (kGroups ? tg : kn) * kChunkC * COB;
  const bool two = (flags & kF32TwoStages) != 0;
  const int tid = threadIdx.x;
  const int cl = tid % 8;
  const int tc = (tid / 8) % T::kCL;
  const int row = (tid / 8) / T::kCL;
  const int q = (o0 + row) & 1;
  const int n_groups = kGroups ? (kn + tg - 1) / tg : 1;
  const int n_steps = (Cin + kChunkC - 1) / kChunkC * n_groups;
#pragma unroll
  for (int i = 0; i < kF32Pix; ++i)
#pragma unroll
    for (int j = 0; j < T::kCT; ++j) acc[i][j] = 0.f;

  // step s: chunk s / n_groups, taps t0 .. t1 - 1 of group s % n_groups,
  // which reach rows lo .. lo + rows - 1
  auto group = [&](int s, int& t0, int& t1, int& rows) {
    if constexpr (kGroups) {
      t0 = s % n_groups * tg;
      t1 = min(kn, t0 + tg);
      return tap_band(taps, t0, t1, &rows);
    } else {
      t0 = 0;
      t1 = kn;
      rows = n_rows;
      return r_lo;
    }
  };
  auto stage = [&](int s, float* buf) {
    int t0, t1, rows;
    const int lo = group(s, t0, t1, rows);
    conv_tile_stage<COB, kSplit>(buf, buf + patch_floats, xb, xb2, Ca, w, H,
                                 W, Cin, Cout, lo, T::kRows + rows - 1, c_lo,
                                 n_cols, o0, w0, co0,
                                 s / n_groups * kChunkC, t0, t1 - t0, load_w,
                                 flags);
    cp_async_commit();
  };
  stage(0, smem);
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<0>();
    // this step's copies are seen by every thread, and every thread is
    // done with the last step, whose buffer the next one refills (one
    // stage: after this step's multiplies)
    __syncthreads();
    if (two && s + 1 < n_steps)
      stage(s + 1, smem + ((s + 1) & 1) * stage_floats);
    const float* xs = smem + (two ? (s & 1) * stage_floats : 0);
    int t0, t1, rows;
    const int lo = group(s, t0, t1, rows);
    const float* ws = xs + patch_floats + 4 * tc;
    const int kc = min(kChunkC, Cin - s / n_groups * kChunkC);
    auto patch = [&](int t, int& c) {
      c = cl + taps.dc[q][t] - c_lo;
      return xs + ((row + taps.dr[q][t] - lo) * n_cols + c) * kChunkC;
    };
    auto xp = [](const float* xr, int c, int ck) {
      return xr + ((((ck >> 2) ^ (c >> 1)) & 3) << 2) + (ck & 3);
    };
    if (kc == kChunkC) {
      // step ck + 1's operands (at ck = 15 the next tap's first) are read
      // while step ck multiplies
      ConvFrag<COB> f[2];
      int c;
      const float* xr = patch(t0, c);
      f[0].load(xp(xr, c, 0), ws);
      for (int t = t0; t < t1; ++t) {
        const float* wr = ws + (t - t0) * kChunkC * COB;
        const bool more = t + 1 < t1;
        int cn;
        const float* xn = patch(more ? t + 1 : t, cn);
#pragma unroll
        for (int ck = 0; ck < kChunkC; ++ck) {
          if (ck + 1 < kChunkC)
            f[(ck + 1) & 1].load(xp(xr, c, ck + 1), wr + (ck + 1) * COB);
          else if (more)
            f[0].load(xp(xn, cn, 0), wr + kChunkC * COB);
          f[ck & 1].fma(acc);
        }
        xr = xn;
        c = cn;
      }
    } else {
      for (int t = t0; t < t1; ++t) {
        int c;
        const float* xr = patch(t, c);
        for (int ck = 0; ck < kc; ++ck) {
          ConvFrag<COB> f;
          f.load(xp(xr, c, ck), ws + ((t - t0) * kChunkC + ck) * COB);
          f.fma(acc);
        }
      }
    }
    if (!two && s + 1 < n_steps) {
      __syncthreads();
      stage(s + 1, smem);
    }
  }
  __syncthreads();   // every thread is done with smem
}

// ---- the conv pass's bf16 tensor-core tile --------------------------------
//
// hex_conv_layer.cu's bfloat16 conv pass (TPU kernels #9, #10 and its split
// mode, and the dx half of #12), as an implicit GEMM on Hopper's warpgroup
// MMA.  One block (one warpgroup, kConvThreads = 128 threads) computes one
// output row o, which fixes the row parity q = o & 1 and so the tap table:
// M = kTileP = 64 consecutive output pixels, N output channels (16, 32, 64
// or 128: conv_tile_mma_n) and K = kn x Cin, walked as (16-channel chunk,
// tap) in that order, the 16 channels of a chunk inside one MMA.
//
//   A: the input patch of the chunk, the rows the taps read (compact_rows:
//      a dilated kernel's rows between its taps are not staged) x (64 + tap
//      width) columns x 16 channels, in bf16, as [row][channel group of 8]
//      [column][8 channels]: each 16-byte unit is 8 channels of one pixel.
//      wgmma's K-major operand without swizzle is a grid of 8-row x 16-byte
//      core matrices, 8 rows 16 bytes apart, the next 8 rows SBO bytes on,
//      the next 8 K values LBO bytes on.  Here 8 consecutive pixels of a
//      patch row are such a core matrix wherever the window starts, so the
//      A tile of tap (dr, dc) is the same patch seen from the unit at row
//      dr - r_lo, column dc - c_lo (SBO 128 bytes, LBO one channel group's
//      plane, n_cols x 16 bytes): a descriptor per tap, nothing re-staged.
//   B: the chunk's weights, [tap][channel group][N][8 channels], K-major
//      the same way (SBO 128, LBO N x 16); the wrapper packs them once a
//      call into (chunks, kn, 2, Cout, 8) bf16 (conv_stack.py::
//      _pack_mma_weights), so that a block's slab is a plain copy.
//   D: f32 in registers, N / 2 a thread: wgmma.mma_async m64nNk16
//      (bf16 x bf16 -> f32), kn of them a chunk, committed as one group.
//
// Copies: the next chunk's patch and weights are staged with cp.async (16
// bytes a thread) into the other of two buffers while the tensor cores work
// on this one.  Rows and columns outside the image and channels past Cin
// come from the same 16-byte copy with a source size of 0 (zero fill).
// Where a 16-byte unit does not lie whole in one input (Cin, or the split's
// Ca, not a multiple of 8, or an input not 16-byte aligned), the same loop
// stages it element by element into the same layout; the MMAs are the
// same.  The split input (kSplit) picks A or B per unit or per element, so
// the concatenation is never built and the tile is bit-equal to the
// unsplit one on the materialised concatenation.
//
// Why wgmma and not mma.sync: the shifted windows are exact descriptors in
// the no-swizzle layout, so the warpgroup MMA reads both operands straight
// from shared memory with no ldmatrix or register staging, and only the
// warpgroup MMA reaches the card's full bf16 tensor rate.  The
// no-swizzle layout costs shared-memory bank conflicts that a swizzled one
// would not, but a swizzled window could not start at every column.
//
// An output channel's sum is the same whatever N is (the MMA sums each
// output column alone, in the same K order), so a split dgrad cut at Ca
// equals the unsplit one bit for bit.  The order differs from conv_tile's,
// so in bfloat16 this tile and conv_tile agree only to rounding.

template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float (&d)[8], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

// A wgmma shared-memory descriptor for a K-major operand without swizzle:
// start address, leading (K) and stride (M/N) byte offsets, in 16 bytes.
__device__ __forceinline__ uint64_t mma_desc(const void* p, uint32_t lbo,
                                             uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// the accumulators are not read or written across a wgmma in flight
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// 16-byte units of one stage's patch.
__host__ __device__ inline int mma_patch_units(int n_rows, int n_cols) {
  return n_rows * 2 * n_cols;
}

// Shared memory of conv_tile_mma, in bytes: two stages (one when a single
// 16-channel chunk covers Cin).
inline size_t conv_tile_mma_smem(const Geometry& g, int kn, int n, int cin) {
  const size_t stages = cin > kChunkC ? 2 : 1;
  return stages * 16 *
         ((size_t)mma_patch_units(g.n_rows, g.n_cols) + (size_t)kn * 2 * n);
}

// The tile's N for Cout: the least of 16, 32, 64, 128 that covers it (128
// above), halved while the stages do not fit in shared memory, down to 16
// (where they need less than the float32 tile, conv_tile_smem, does).
// kernels/conv_stack.py::_tile_n mirrors it.
inline int conv_tile_mma_n(const Geometry& g, int kn, int cin, int cout) {
  int n = cout <= 16 ? 16 : cout <= 32 ? 32 : cout <= 64 ? 64 : 128;
  while (n > 16 && conv_tile_mma_smem(g, kn, n, cin) > (size_t)kMmaMaxSmem)
    n /= 2;
  return n;
}

// One chunk's patch (input channels ci0 .. ci0 + 15) into xs, laid out
// [row][group][column] in 16-byte units, patch row r from input row o +
// rows.dr[r] (compact_rows).  Consecutive threads take the two groups of a
// pixel, then the next pixel: consecutive 16-byte global reads when Cin =
// 16.
template <bool kSplit>
__device__ __forceinline__ void stage_patch(
    uint4* xs, const __nv_bfloat16* __restrict__ xb,
    const __nv_bfloat16* __restrict__ xb2, int Ca, int H, int W, int Cin,
    const RowMap& rows, int n_rows, int c_lo, int n_cols, int o, int w0,
    int ci0, bool vec) {
  const int n_units = mma_patch_units(n_rows, n_cols);
  for (int e = threadIdx.x; e < n_units; e += kConvThreads) {
    const int grp = e & 1;
    const int c = (e >> 1) % n_cols;
    const int r = (e >> 1) / n_cols;
    const int gi = o + rows.dr[r], gj = w0 + c_lo + c, gc = ci0 + 8 * grp;
    const bool inside = gi >= 0 && gi < H && gj >= 0 && gj < W;
    const long long pix = (long long)gi * W + gj;
    uint4* dst = xs + (r * 2 + grp) * n_cols + c;
    if (vec) {
      const __nv_bfloat16* src = xb;   // not read when nothing is copied
      int bytes = 0;
      if (inside && gc < Cin) {
        bytes = 16;
        if constexpr (kSplit)
          src = gc < Ca ? xb + pix * Ca + gc
                        : xb2 + pix * (Cin - Ca) + (gc - Ca);
        else
          src = xb + pix * Cin + gc;
      }
      cp_async16(dst, src, bytes);
    } else {
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cc = gc + j;
        v[j] = __float2bfloat16(0.f);
        if (inside && cc < Cin) {
          if constexpr (kSplit)
            v[j] = cc < Ca ? xb[pix * Ca + cc]
                           : xb2[pix * (Cin - Ca) + (cc - Ca)];
          else
            v[j] = xb[pix * Cin + cc];
        }
      }
      *dst = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// One chunk's weights for output channels co0 .. co0 + N - 1 into ws,
// [tap][group][N] in 16-byte units, from the packed (chunks, kn, 2, Cout,
// 8) bf16 weights; channels past Cout are zero-filled.
template <int N>
__device__ __forceinline__ void stage_weights(
    uint4* ws, const __nv_bfloat16* __restrict__ w, int chunk, int kn,
    int Cout, int co0) {
  const uint4* wc = reinterpret_cast<const uint4*>(w) +
                    (long long)chunk * kn * 2 * Cout;
  const int n_units = kn * 2 * N;
  for (int e = threadIdx.x; e < n_units; e += kConvThreads) {
    const int co = co0 + e % N;
    const int tg = e / N;                 // tap * 2 + group
    cp_async16(ws + e, co < Cout ? wc + (long long)tg * Cout + co : wc,
               co < Cout ? 16 : 0);
  }
}

// Accumulate the tile at output row o, pixels w0 .. w0 + 63, output
// channels co0 .. co0 + N - 1 of the NHWC sample xb (H, W, Cin) (kSplit:
// channels [0, Ca) from xb (H, W, Ca), the rest from xb2 (H, W, Cin - Ca))
// into acc, in wgmma's accumulator layout: thread t of warp t / 32, lane
// l = t % 32, holds acc[4 i + 2 h + j] = pixel w0 + 16 (t / 32) + l / 4 +
// 8 h, channel co0 + 8 i + 2 (l % 4) + j.  w: the packed weights; smem
// holds conv_tile_mma_smem bytes, 16-byte aligned; vec: every 16-byte unit
// of the inputs is one aligned copy (see stage_patch).  taps, r_lo and
// n_rows are compact_rows' (each tap's row its patch row), rows its map.
template <int N, bool kSplit>
__device__ __forceinline__ void conv_tile_mma(
    const __nv_bfloat16* __restrict__ xb,
    const __nv_bfloat16* __restrict__ xb2, int Ca,
    const __nv_bfloat16* __restrict__ w, uint4* smem, int H, int W,
    int Cin, int Cout, int kn, const TapTable& taps, const RowMap& rows,
    int r_lo, int n_rows, int c_lo, int n_cols, int o, int w0, int co0,
    bool vec, float (&acc)[N / 2]) {
  const int q = o & 1;
  const int n_chunks = (Cin + kChunkC - 1) / kChunkC;
  const int x_units = mma_patch_units(n_rows, n_cols);
  const int stage_units = x_units + kn * 2 * N;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;

  auto stage = [&](int chunk) {
    uint4* xs = smem + (chunk & 1) * stage_units;
    stage_patch<kSplit>(xs, xb, xb2, Ca, H, W, Cin, rows, n_rows, c_lo,
                        n_cols, o, w0, chunk * kChunkC, vec);
    stage_weights<N>(xs + x_units, w, chunk, kn, Cout, co0);
    cp_async_commit();
  };
  stage(0);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    if (chunk + 1 < n_chunks) {
      stage(chunk + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // this thread's copies and stores, seen by the tensor cores' proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint4* xs = smem + (chunk & 1) * stage_units;
    const uint4* ws = xs + x_units;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    for (int t = 0; t < kn; ++t) {
      const uint4* a = xs + (taps.dr[q][t] - r_lo) * 2 * n_cols +
                       (taps.dc[q][t] - c_lo);
      Wgmma<N>::mma(acc, mma_desc(a, n_cols * 16, 128),
                    mma_desc(ws + t * 2 * N, N * 16, 128));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    __syncthreads();   // the buffer is free for the chunk after next
  }
}


// ---- the same tensor-core tile on NCHW input (hex_conv_single.cu) --------
//
// conv_tile_mma's patch layout filled from an NCHW sample (Cin, H, W): a
// 16-byte unit is 8 channels of one pixel, which NCHW holds one plane
// apart, so no copy engine can move it whole.  Each thread gathers the 8
// channels of one unit (8 loads, consecutive threads on consecutive
// columns, so each load is coalesced across the warp) and stores the unit
// in one 16-byte write (consecutive threads on consecutive units: no bank
// conflicts).  It is the transposing twin of stage_patch's element-wise
// branch: the same units, the same zeros outside the image and past Cin.
__device__ __forceinline__ void stage_patch_nchw(
    uint4* xs, const __nv_bfloat16* __restrict__ xb, int H, int W, int Cin,
    int r_lo, int n_rows, int c_lo, int n_cols, int o, int w0, int ci0) {
  const int n_units = mma_patch_units(n_rows, n_cols);
  const long long plane = (long long)H * W;
  for (int e = threadIdx.x; e < n_units; e += kConvThreads) {
    const int c = e % n_cols;
    const int rg = e / n_cols;            // row * 2 + group
    const int gi = o + r_lo + (rg >> 1), gj = w0 + c_lo + c;
    const int gc = ci0 + 8 * (rg & 1);
    const bool inside = gi >= 0 && gi < H && gj >= 0 && gj < W;
    const __nv_bfloat16* src = xb + ((long long)gc * H + gi) * W + gj;
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = inside && gc + j < Cin ? src[j * plane] : __float2bfloat16(0.f);
    xs[rg * n_cols + c] = *reinterpret_cast<const uint4*>(v);
  }
}

// conv_tile_mma on the NCHW sample xb (Cin, H, W): the same units, weights,
// K order and MMAs, so the result is bit-equal to conv_tile_mma's on the
// same values in NHWC.  The staging is synchronous, so it runs while the
// tensor cores work: chunk c's MMAs are issued, chunk c + 1's patch is
// gathered into the other buffer (its weights by cp.async), then the MMAs
// are waited on.
template <int N>
__device__ __forceinline__ void conv_tile_mma_nchw(
    const __nv_bfloat16* __restrict__ xb, const __nv_bfloat16* __restrict__ w,
    uint4* smem, int H, int W, int Cin, int Cout, int kn,
    const TapTable& taps, int r_lo, int n_rows, int c_lo, int n_cols, int o,
    int w0, int co0, float (&acc)[N / 2]) {
  const int q = o & 1;
  const int n_chunks = (Cin + kChunkC - 1) / kChunkC;
  const int x_units = mma_patch_units(n_rows, n_cols);
  const int stage_units = x_units + kn * 2 * N;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;

  auto stage = [&](int chunk) {
    uint4* xs = smem + (chunk & 1) * stage_units;
    stage_patch_nchw(xs, xb, H, W, Cin, r_lo, n_rows, c_lo, n_cols, o, w0,
                     chunk * kChunkC);
    stage_weights<N>(xs + x_units, w, chunk, kn, Cout, co0);
    cp_async_commit();
  };
  stage(0);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    cp_async_wait<0>();
    // this thread's copies and stores, seen by the tensor cores' proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint4* xs = smem + (chunk & 1) * stage_units;
    const uint4* ws = xs + x_units;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    for (int t = 0; t < kn; ++t) {
      const uint4* a = xs + (taps.dr[q][t] - r_lo) * 2 * n_cols +
                       (taps.dc[q][t] - c_lo);
      Wgmma<N>::mma(acc, mma_desc(a, n_cols * 16, 128),
                    mma_desc(ws + t * 2 * N, N * 16, 128));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the other buffer was last read by chunk - 1's MMAs, which every
    // thread waited on before the barrier above
    if (chunk + 1 < n_chunks) stage(chunk + 1);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
  }
}

}  // namespace hg
