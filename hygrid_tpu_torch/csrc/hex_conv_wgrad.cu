// hex_conv_wgrad: the weight gradient of one stride-1 'same' hex conv layer,
//
//   dW[co, ci, t] = sum_{b, o, j} x[b, o + dr[q][t], j + dc[q][t], ci]
//                                 * g[b, o, j, co],     q = o % 2,
//
// x the layer's NHWC input, g the cotangent of its pre-activation, zero
// outside the image, accumulated in float32.
//
// Replaces: the dL/dM half of hygrid_tpu/kernels/conv_pallas.py::
// _stack_layer_bwd_kernel (:1402, launched at :1884; per-slot x_blk^T @ g
// matmuls on Kronecker-packed planes, summed over the sequential batch grid
// in VMEM).  Its dL/dx half is hex_conv_layer.cu's conv pass with the
// adjoint tap table.  On the split layer (12s) the same kernel runs on each
// input.
//
// What bounds it: arithmetic.  At HexCNN-small's 512^2 b=32 shapes the six
// layers' dW are about 120 GFLOP, reduced over up to B*H*W = 2.1 M pixels
// per (tap, ci, co): no block can see a whole reduction.  On a TPU the grid
// is sequential and the sum stays in VMEM; here blocks run in any order, so
// the reduction is two deterministic passes with no float atomics:
//   1. a partial pass, grid (chunk of image rows, ...), writes each chunk's
//      sums to partial[chunk][t][ci][co];
//   2. wgrad_finalize_kernel folds the chunks in chunk order into
//      dW (Cout, Cin, kn).
//
// bfloat16, the partial pass on the tensor cores (wgrad_mma_kernel): per
// tap a GEMM dW_t (M = 64 output channels) x (N = 8, 16 or 32 input
// channels) over K = the chunk's pixels, wgmma m64nNk16 bf16 x bf16 -> f32.
// A step stages 64 pixels of one output row of g and the x patch its taps
// read (the rows among r_lo .. r_hi around it that a tap reads, as
// hg::compact_rows keeps them: 3 rows at any dilation of a radius-2
// kernel, x 64 + tap width columns) in shared memory, both as 16-byte units of 8 channels of one pixel, as NHWC
// holds them.  8 consecutive pixels of one channel group are then the
// MN-major ("transposed") core matrix that bf16 wgmma reads for A and B:
// A = g^T with co contiguous, B = the x window with ci contiguous, K =
// pixels.  So a tap's shifted window is a descriptor offset into the one
// staged patch, as in hex_common.cuh::conv_tile_mma; nothing is staged per
// tap.  Each block holds up to kTapsBlk taps' 64 x N f32 accumulators in
// registers (7 x 16 a thread at N = 32), or the one tap's of a one-tap
// kernel (a 1 x 1 conv); more taps take more blocks.  The
// next two steps are copied with cp.async (16-byte units, zero fill at the
// image edges) while this one multiplies; where a unit is not whole in
// memory (Cin or Cout not a multiple of 8, as at the 3-channel stem) it is
// staged element by element into the same layout.  The wrapper cuts the
// rows into fixed chunks, about 792 blocks in all (conv_stack.py::
// _wgrad_chunks): few, long blocks write few partial sums.  The chunks
// depend on the shapes alone, so every card folds the same partial sums
// and gives the same bits.
//
// float32, the partial pass on the CUDA cores in full f32 FMAs
// (wgrad_partial_kernel), on the bf16 pass's structure.  Grid (chunk, tap
// group, input-channel tile x output-channel tile); a block is one warp a
// tap, up to kWgTaps taps (all seven at radius 2), and covers CIB = 8, 16
// or 32 input x COB = 32 or 64 output channels (conv_stack.py::_wgrad_tile
// mirrors the choice).  A step stages KP = 64 pixels (128 where CIB = 8)
// of one output row of g (KP x COB) and the x patch its taps reach (the
// rows r_lo .. r_hi x KP + tap width columns x CIB), both NHWC as 16-byte
// cp.async units (element by element where Cin or Cout is not a multiple
// of 4), once for every tap: a tap's window is an offset into the patch.
// The patch grows with the rows the taps reach (2 d + 1 at dilation d);
// where it does not fit, a block takes fewer taps, down to one (one row),
// and more blocks cover the taps (wgrad_f32_plan).  A tap's sums do not
// depend on its block, so no bit moves.
// The next step is copied while this one multiplies, behind one barrier a
// step; each thread reads the next pixel's operands while it multiplies
// this one's.  Each thread holds an 8 x 8 (ci, co)
// tile of its warp's tap, 64 f32 accumulators, and per pixel reads two
// float4 of x and two of g for 64 FMAs; where CIB x COB / 64 is under 32
// lanes, the warp's lanes split the pixels into PS interleaved slices,
// folded by shuffles at the end.  The pixel strides of the staged x and g
// are padded so that the slices' reads fall in distinct banks.  About 792
// blocks in all, as in bf16.
#include "hex_common.cuh"

namespace {

using hg::kMaxTaps;
using hg::TapTable;

constexpr int kWgTaps = 8;      // taps a block at most: one a warp

// The float32 tile: CIB input x COB output channels, 8 x 8 a thread (two
// groups of 4 of each, CIB / 2 and COB / 2 apart), CIL x COL channel lanes
// and PS pixel slices a warp; SX and SG the staged pixel strides of x and g
// in floats; KP pixels of one output row a step (128 where CIB = 8: a
// thread's share of a step is then 16 pixels, enough to hide the next
// step's copies).  conv_stack.py::_wgrad_f32_plan mirrors it.
template <int CIB, int COB>
struct WgradTile {
  static_assert((CIB == 8 || CIB == 16 || CIB == 32) &&
                (COB == 32 || COB == 64), "the tile's widths");
  static constexpr int kCIL = CIB / 8, kCOL = COB / 8;
  static constexpr int kPS = 32 / (kCIL * kCOL);
  static constexpr int kSX = kPS > 1 ? CIB * 3 / 2 : CIB;
  static constexpr int kSG = COB == 32 ? 48 : COB;
  static constexpr int kKP = CIB == 8 ? 128 : 64;
  static_assert(kKP % kPS == 0, "pixel slices");
};

// Shared memory of the float32 partial pass, in bytes, for a patch of
// n_rows (the rows a block's taps reach) x (64 + tap width) columns around
// 64 pixels.
template <int CIB, int COB>
size_t wgrad_f32_smem(int n_rows, int n_cols, int stages) {
  using T = WgradTile<CIB, COB>;
  return sizeof(float) * stages *
         ((size_t)T::kKP * T::kSG +
          (size_t)n_rows * (n_cols - 64 + T::kKP) * T::kSX);
}

// The taps a block takes: kn in ceil(kn / kWgTaps) groups as even as they
// go.
inline int wgrad_f32_taps(int kn) {
  const int groups = (kn + kWgTaps - 1) / kWgTaps;
  return (kn + groups - 1) / groups;
}

// A thread's operands of one pixel: its 8 input channels of x and its 8
// output channels of g, two float4 each.
template <int CIB, int COB>
struct WgradFrag {
  float4 x[2], g[2];

  __device__ __forceinline__ void load(const float* xp, const float* gp) {
    x[0] = *reinterpret_cast<const float4*>(xp);
    x[1] = *reinterpret_cast<const float4*>(xp + CIB / 2);
    g[0] = *reinterpret_cast<const float4*>(gp);
    g[1] = *reinterpret_cast<const float4*>(gp + COB / 2);
  }

  __device__ __forceinline__ void fma(float (&acc)[8][8]) const {
    const float xv[8] = {x[0].x, x[0].y, x[0].z, x[0].w,
                         x[1].x, x[1].y, x[1].z, x[1].w};
    const float gv[8] = {g[0].x, g[0].y, g[0].z, g[0].w,
                         g[1].x, g[1].y, g[1].z, g[1].w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], gv[j], acc[i][j]);
  }
};

// x, g: NHWC float32; partial as hg_hex_conv_wgrad.  Block (chunk, tap
// group, channel tiles), 32 threads a tap; flags: 1 x in 16-byte units
// (Cin % 4 == 0, aligned), 2 the same for g, 4 two stages.  rows = B x H
// (under 2^31, as the wrapper's checks keep it).  table_r_lo, table_rows:
// the rows the whole tap table reaches, which a block stages unless
// kBands (then only the rows its own taps reach).
template <int CIB, int COB, bool kBands>
__global__ void __launch_bounds__(kWgTaps * 32, 2)
wgrad_partial_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     float* __restrict__ partial, int H, int W, int Cin,
                     int Cout, int kn, const __grid_constant__ TapTable taps,
                     int table_r_lo, int table_rows, int c_lo, int n_cols,
                     int rows, int rows_per_chunk, int flags) {
  using T = WgradTile<CIB, COB>;
  constexpr int PS = T::kPS, SX = T::kSX, SG = T::kSG, KP = T::kKP;
  extern __shared__ __align__(16) float wsm[];
  const int nthreads = blockDim.x;
  const int tb = nthreads / 32;
  const int chunk = blockIdx.x;
  const int t0 = blockIdx.y * tb;
  const int nt = min(tb, kn - t0);
  // the patch: the rows r_lo .. r_lo + n_rows - 1 the block's taps reach
  // (kBands), or the table's
  int n_rows = table_rows;
  const int r_lo =
      kBands ? hg::tap_band(taps, t0, t0 + nt, &n_rows) : table_r_lo;
  const int g_floats = KP * SG;
  const int stage_floats = g_floats + n_rows * n_cols * SX;
  const int n_co = (Cout + COB - 1) / COB;
  const int ci0 = (blockIdx.z / n_co) * CIB;
  const int co0 = (blockIdx.z % n_co) * COB;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(r0 + rows_per_chunk, rows);
  const int per_row = (W + KP - 1) / KP;
  const int n_steps = (r1 - r0) * per_row;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int col = lane % T::kCOL;
  const int cil = (lane / T::kCOL) % T::kCIL;
  const int sl = lane / (T::kCOL * T::kCIL);
  const bool two = (flags & 4) != 0;

  // step s: output row r0 + s / per_row (row o of its sample), pixels
  // j0 .. j0 + 63
  auto stage = [&](int s, float* gs) {
    float* xs = gs + g_floats;
    const int row = r0 + s / per_row;
    const int j0 = (s % per_row) * KP;
    const int o = row % H;
    const int sample = row - o;               // the sample's first row
    const float* grow = g + ((long long)row * W + j0) * Cout + co0;
    // each thread keeps its part of a pixel (a unit, or all its
    // elements) and walks the pixels with pointer steps: no division a
    // copy
    if (flags & 2) {
      constexpr int U = COB / 4;
      const int u = tid % U, dp = nthreads / U;
      const bool co_live = co0 + 4 * u < Cout;
      for (int p = tid / U; p < KP; p += dp) {
        const bool live = co_live && j0 + p < W;
        hg::cp_async16(gs + p * SG + 4 * u,
                       live ? grow + (long long)p * Cout + 4 * u : g,
                       live ? 16 : 0);
      }
    } else {
      for (int p = tid; p < KP; p += nthreads)
        for (int u = 0; u < COB; ++u) {
          const bool live = j0 + p < W && co0 + u < Cout;
          hg::cp_async4(gs + p * SG + u,
                        live ? grow + (long long)p * Cout + u : g,
                        live ? 4 : 0);
        }
    }
    // x: the patch's pixels pc = r * n_cols + c; channels past Cin are
    // not staged (they reach only accumulators that are never stored)
    if (flags & 1) {
      constexpr int U = CIB / 4;
      const int u = tid % U, dpc = nthreads / U;
      const bool ci_live = ci0 + 4 * u < Cin;
      int pc = tid / U;
      int r = pc / n_cols, c = pc - r * n_cols;
      for (; r < n_rows; pc += dpc) {
        const int xi = o + r_lo + r, xj = j0 + c_lo + c;
        const bool live = ci_live && xi >= 0 && xi < H && xj >= 0 && xj < W;
        hg::cp_async16(
            xs + pc * SX + 4 * u,
            live ? x + ((long long)(sample + xi) * W + xj) * Cin + ci0 + 4 * u
                 : x,
            live ? 16 : 0);
        c += dpc;
        while (c >= n_cols) {
          c -= n_cols;
          ++r;
        }
      }
    } else {
      const int kcw = min(CIB, Cin - ci0);
      for (int pc = tid; pc < n_rows * n_cols; pc += nthreads) {
        const int r = pc / n_cols, c = pc - r * n_cols;
        const int xi = o + r_lo + r, xj = j0 + c_lo + c;
        const bool inside = xi >= 0 && xi < H && xj >= 0 && xj < W;
        const float* src =
            x + ((long long)(sample + xi) * W + xj) * Cin + ci0;
        for (int u = 0; u < kcw; ++u)
          hg::cp_async4(xs + pc * SX + u, inside ? src + u : x,
                        inside ? 4 : 0);
      }
    }
    hg::cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // thread (warp, lane): tap t0 + warp, input channels ci0 + h CIB / 2 +
  // 4 cil + j, output channels co0 + h COB / 2 + 4 col + j, the step's
  // pixels p with p % PS == sl, in order
  const int t = t0 + min(warp, nt - 1);
  if (n_steps > 0) stage(0, wsm);
  for (int s = 0; s < n_steps; ++s) {
    hg::cp_async_wait<0>();
    // step s's copies are seen by every thread, and every warp is done
    // with step s - 1, whose buffer step s + 1 refills (one stage: after
    // this step's multiplies)
    __syncthreads();
    if (two && s + 1 < n_steps)
      stage(s + 1, wsm + ((s + 1) & 1) * stage_floats);
    if (warp < nt) {
      const float* gs = wsm + (two ? (s & 1) * stage_floats : 0);
      const float* xs = gs + g_floats;
      const int q = ((r0 + s / per_row) % H) & 1;
      const float* xr = xs + ((taps.dr[q][t] - r_lo) * n_cols +
                              taps.dc[q][t] - c_lo + sl) * SX + 4 * cil;
      const float* gr = gs + sl * SG + 4 * col;
      // pixel k + 1's operands are read while pixel k multiplies
      constexpr int NP = KP / PS;
      WgradFrag<CIB, COB> f[2];
      f[0].load(xr, gr);
#pragma unroll 4
      for (int k = 0; k < NP; ++k) {
        if (k + 1 < NP)
          f[(k + 1) & 1].load(xr + (k + 1) * PS * SX, gr + (k + 1) * PS * SG);
        f[k & 1].fma(acc);
      }
    }
    if (!two && s + 1 < n_steps) {
      __syncthreads();
      stage(s + 1, wsm);
    }
  }

  // fold the pixel slices (lanes CIL x COL apart): the same butterfly in
  // every warp
#pragma unroll
  for (int off = T::kCIL * T::kCOL; off < 32; off *= 2)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], off);
  if (warp >= nt || sl != 0) return;
  float* out = partial + ((long long)chunk * kn + t) * Cin * Cout;
  const bool vec_out = Cout % 4 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ci = ci0 + (i / 4) * (CIB / 2) + 4 * cil + i % 4;
    if (ci >= Cin) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + h * (COB / 2) + 4 * col;
      if (co >= Cout) continue;
      float* op = out + (long long)ci * Cout + co;
      if (vec_out) {
        *reinterpret_cast<float4*>(op) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (co + j < Cout) op[j] = acc[i][4 * h + j];
      }
    }
  }
}

// ---- bfloat16: the tensor-core partial pass --------------------------------

constexpr int kMmaM = 64;       // output channels a block (wgmma's M)
constexpr int kStepP = 64;      // pixels a step: four k16 MMAs per tap
constexpr int kTapsBlk = 7;     // taps a block
constexpr int kGStride = kStepP + 1;  // units between g's channel groups
constexpr int kMmaThreads = 128;      // one warpgroup
constexpr int kMmaStages = 3;         // steps staged or in flight

// The block's N (input channels): 8, 16 or 32 (conv_stack.py::_wgrad_tile
// mirrors it).
__host__ __device__ inline int wgrad_mma_n(int cin) {
  return cin <= 8 ? 8 : cin <= 16 ? 16 : 32;
}

// wgmma m64nNk16, A and B from shared memory, both MN-major (imm-trans-a
// and imm-trans-b 1): D[m][n] += sum_k A[m][k] * B[k][n] with A's 8 m of
// one k, and B's 8 n of one k, the 16 contiguous bytes of a core matrix row.
template <int N>
struct WgmmaT;

template <>
struct WgmmaT<8> {
  __device__ __forceinline__ static void mma(float (&d)[4], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaT<16> {
  __device__ __forceinline__ static void mma(float (&d)[8], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaT<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

// One 16-byte unit of 8 channels c0 .. c0 + 7 of pixel `pix` of an NHWC
// tensor with C channels into dst: one cp.async where the unit is whole
// (vec), else element by element; zeros where `inside` is false and past C.
__device__ __forceinline__ void stage_unit(uint4* dst,
                                           const __nv_bfloat16* __restrict__ t,
                                           long long pix, int C, int c0,
                                           bool inside, bool vec) {
  if (vec) {
    const bool ok = inside && c0 < C;
    hg::cp_async16(dst, ok ? t + pix * C + c0 : t, ok ? 16 : 0);
  } else {
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = inside && c0 + j < C ? t[pix * C + c0 + j]
                                  : __float2bfloat16(0.f);
    *dst = *reinterpret_cast<const uint4*>(v);
  }
}

// grid (chunk, tap group of TB, output-channel tile x input-channel
// tile).  Shared memory: kMmaStages stages of [8][kGStride] g units (64
// channels x 64 pixels, the channel groups padded apart so the copies do
// not conflict) and [n_rows][N / 8][n_cols] x units, patch row r from input
// row o + rmap.dr[r] (hg::compact_rows: taps, r_lo and n_rows are its).
// Step s's MMAs are issued, then step s + 2's copies, then the MMAs are
// waited on: two steps' copies are in flight while the tensor cores work.
template <int N, int TB>
__global__ void __launch_bounds__(kMmaThreads)
wgrad_mma_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ g,
                 float* __restrict__ partial, int H, int W, int Cin,
                 int Cout, int kn, const __grid_constant__ TapTable taps,
                 const __grid_constant__ hg::RowMap rmap, int r_lo,
                 int n_rows, int c_lo, int n_cols, long long rows,
                 int rows_per_chunk, int vec_x, int vec_g) {
  constexpr int NG = N / 8;
  extern __shared__ __align__(16) uint4 smem_u[];
  const int g_units = 8 * kGStride;
  const int stage_units = g_units + n_rows * NG * n_cols;
  const int chunk = blockIdx.x;
  const int t0 = blockIdx.y * TB;
  const int nt = min(TB, kn - t0);
  const int n_ci = (Cin + N - 1) / N;
  const int co0 = (blockIdx.z / n_ci) * kMmaM;
  const int ci0 = (blockIdx.z % n_ci) * N;
  const long long r0 = (long long)chunk * rows_per_chunk;
  const long long r1 = min(r0 + rows_per_chunk, rows);
  const int per_row = (W + kStepP - 1) / kStepP;
  const int n_steps = (int)(r1 - r0) * per_row;
  const int tid = threadIdx.x;

  // step s: output row r0 + s / per_row (row o of its sample), pixels
  // j0 .. j0 + 63
  auto stage = [&](int s) {
    uint4* gs = smem_u + (s % kMmaStages) * stage_units;
    uint4* xs = gs + g_units;
    const long long row = r0 + s / per_row;
    const int j0 = (s % per_row) * kStepP;
    const int o = (int)(row % H);
    // channel groups past Cout (M) or Cin (N) are not staged: they only
    // reach accumulator rows and columns that are never stored
    for (int e = tid; e < 8 * kStepP; e += kMmaThreads) {
      const int cg = e % 8, p = e / 8;      // consecutive units in memory
      if (co0 + 8 * cg < Cout)
        stage_unit(gs + cg * kGStride + p, g, row * W + j0 + p, Cout,
                   co0 + 8 * cg, j0 + p < W, vec_g);
    }
    const int x_units = n_rows * NG * n_cols;
    for (int e = tid; e < x_units; e += kMmaThreads) {
      const int cig = e % NG, c = (e / NG) % n_cols, r = e / (NG * n_cols);
      const int xi = o + rmap.dr[r], xj = j0 + c_lo + c;
      if (ci0 + 8 * cig < Cin)
        stage_unit(xs + (r * NG + cig) * n_cols + c, x,
                   (row - o + xi) * W + xj, Cin, ci0 + 8 * cig,
                   xi >= 0 && xi < H && xj >= 0 && xj < W, vec_x);
    }
    hg::cp_async_commit();
  };

  float acc[TB][N / 2];
#pragma unroll
  for (int t = 0; t < TB; ++t)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[t][i] = 0.f;

  // a block's last tap group may hold fewer taps: the missing ones repeat
  // its last tap into accumulators that are never stored, so every step
  // issues the same MMAs with no branch among them
  int tap[TB];
#pragma unroll
  for (int t = 0; t < TB; ++t) tap[t] = t0 + min(t, nt - 1);

#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < n_steps) stage(s);
    else hg::cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    hg::cp_async_wait<kMmaStages - 2>();     // step s has landed
    // this thread's copies and stores, seen by the tensor cores' proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint4* gs = smem_u + (s % kMmaStages) * stage_units;
    const uint4* xs = gs + g_units;
    const int q = (int)((r0 + s / per_row) % H) & 1;
#pragma unroll
    for (int t = 0; t < TB; ++t) hg::fence_acc(acc[t]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int t = 0; t < TB; ++t) {
      const uint4* xw = xs + (taps.dr[q][tap[t]] - r_lo) * NG * n_cols +
                        (taps.dc[q][tap[t]] - c_lo);
#pragma unroll
      for (int kk = 0; kk < kStepP / 16; ++kk)
        // A: 8 pixels x 8 channels core matrices, the next 8 pixels 128
        // bytes on (LBO), the next 8 channels one group's row on (SBO)
        WgmmaT<N>::mma(acc[t],
                       hg::mma_desc(gs + 16 * kk, 128, kGStride * 16),
                       hg::mma_desc(xw + 16 * kk, 128, n_cols * 16));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the buffer of step s + 2 was last read by step s - 1's MMAs, which
    // every thread waited on before the barrier above
    if (s + kMmaStages - 1 < n_steps) stage(s + kMmaStages - 1);
    else hg::cp_async_commit();
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int t = 0; t < TB; ++t) hg::fence_acc(acc[t]);
  }

  // acc[t][4 i + 2 h + j]: output channel co0 + 16 warp + lane / 4 + 8 h,
  // input channel ci0 + 8 i + 2 (lane % 4) + j
  const int lane = tid % 32;
#pragma unroll
  for (int t = 0; t < TB; ++t) {
    if (t >= nt) break;
    float* out = partial + ((long long)chunk * kn + t0 + t) * Cin * Cout;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + 16 * (tid / 32) + lane / 4 + 8 * h;
      if (co >= Cout) continue;
#pragma unroll
      for (int i = 0; i < NG; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ci = ci0 + 8 * i + 2 * (lane % 4) + j;
          if (ci < Cin)
            out[(long long)ci * Cout + co] = acc[t][4 * i + 2 * h + j];
        }
    }
  }
}

size_t wgrad_mma_smem(int n, int n_rows, int n_cols) {
  return kMmaStages * 16 *
         ((size_t)8 * kGStride + (size_t)n_rows * (n / 8) * n_cols);
}

// The x patch's columns: 64 + the tap table's column range.
int mma_patch_cols(const hg::Geometry& geo) {
  return geo.n_cols - hg::kTileP + kStepP;
}

template <int N, int TB>
int launch_mma(const void* x, const void* g, float* partial, int B, int H,
               int W, int Cin, int Cout, int kn, const hg::Geometry& geo,
               const hg::RowMap& rmap, int rows_per_chunk, int n_chunks,
               cudaStream_t stream) {
  const long long tiles =
      (long long)((Cout + kMmaM - 1) / kMmaM) * ((Cin + N - 1) / N);
  if (tiles > 65535) return -1;
  const size_t smem = wgrad_mma_smem(N, geo.n_rows, mma_patch_cols(geo));
  if (smem > (size_t)hg::kMmaMaxSmem) return -1;
  auto kernel = wgrad_mma_kernel<N, TB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_x = Cin % 8 == 0 && aligned(x);
  const int vec_g = Cout % 8 == 0 && aligned(g);
  dim3 grid(n_chunks, (kn + TB - 1) / TB, (unsigned)tiles);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(g), partial, H, W, Cin, Cout, kn,
      geo.taps, rmap, geo.r_lo, geo.n_rows, geo.c_lo, mma_patch_cols(geo),
      (long long)B * H, rows_per_chunk, vec_x, vec_g);
  return (int)cudaGetLastError();
}

// dw[co][ci][t] = sum over chunks, in chunk order, of
// partial[chunk][t][ci][co].  Thread e takes partial element e of a chunk,
// so a warp reads 32 consecutive floats of each chunk; 8 chunks' loads are
// issued before their adds.
__global__ void wgrad_finalize_kernel(const float* __restrict__ partial,
                                      float* __restrict__ dw, int n_chunks,
                                      int kn, int Cin, int Cout) {
  const long long stride = (long long)kn * Cin * Cout;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= stride) return;
  const int co = (int)(e % Cout);
  const int ci = (int)((e / Cout) % Cin);
  const int t = (int)(e / ((long long)Cout * Cin));
  const float* p = partial + e;
  float v = 0.f;
  int k = 0;
  for (; k + 8 <= n_chunks; k += 8) {
    float u[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) u[i] = p[(k + i) * stride];
#pragma unroll
    for (int i = 0; i < 8; ++i) v += u[i];
  }
  for (; k < n_chunks; ++k) v += p[k * stride];
  dw[((long long)co * Cin + ci) * kn + t] = v;
}

// The float32 partial pass's block for CIB x COB: taps a block (a warp
// each: wgrad_f32_taps, fewer where the patch their rows reach does not
// fit, as at a wide dilation), two stages where they fit, else one, and
// the shared bytes.  taps = 0: nothing fits.  conv_stack.py::
// _wgrad_f32_plan mirrors it, and the wrapper's copy must agree.
struct WgradF32Plan {
  int taps, stages;
  int band;   // the most rows one block's taps reach
  size_t smem;
};

template <int CIB, int COB>
WgradF32Plan wgrad_f32_plan(const hg::Geometry& geo, int kn) {
  for (int tb = wgrad_f32_taps(kn); tb >= 1; --tb) {
    const int band = hg::tap_band_rows(geo.taps, kn, tb);
    for (int stages = 2; stages >= 1; --stages) {
      const size_t smem =
          wgrad_f32_smem<CIB, COB>(band, mma_patch_cols(geo), stages);
      if (smem <= (size_t)hg::kMmaMaxSmem) return {tb, stages, band, smem};
    }
  }
  return {0, 0, 0, 0};
}

// plan: the wrapper's CIB, COB, taps a block, stages and shared bytes.
template <int CIB, int COB>
int launch_partial(const void* x, const void* g, float* partial, int B, int H,
                   int W, int Cin, int Cout, int kn, const hg::Geometry& geo,
                   int rows_per_chunk, int n_chunks, const int* plan,
                   cudaStream_t stream) {
  const long long tiles =
      (long long)((Cin + CIB - 1) / CIB) * ((Cout + COB - 1) / COB);
  if (tiles > 65535) return -1;
  const WgradF32Plan pl = wgrad_f32_plan<CIB, COB>(geo, kn);
  if (pl.taps == 0 || plan[0] != CIB || plan[1] != COB ||
      plan[2] != pl.taps || plan[3] != pl.stages || plan[4] != (int)pl.smem)
    return -1;
  // the patch's columns for 64 pixels; a step of KP pixels stages KP - 64
  // more
  const int n_cols = mma_patch_cols(geo) + WgradTile<CIB, COB>::kKP - 64;
  // a block stages the rows its own taps reach where they are fewer than
  // the table's
  auto kernel = pl.band < geo.n_rows ? wgrad_partial_kernel<CIB, COB, true>
                                     : wgrad_partial_kernel<CIB, COB, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return (int)err;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int flags = (Cin % 4 == 0 && aligned(x) ? 1 : 0) |
                    (Cout % 4 == 0 && aligned(g) ? 2 : 0) |
                    (pl.stages == 2 ? 4 : 0);
  dim3 grid(n_chunks, (kn + pl.taps - 1) / pl.taps, (unsigned)tiles);
  kernel<<<grid, 32 * pl.taps, pl.smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), partial,
      H, W, Cin, Cout, kn, geo.taps, geo.r_lo, geo.n_rows, geo.c_lo, n_cols,
      B * H, rows_per_chunk, flags);
  return (int)cudaGetLastError();
}

int finalize(const float* partial, float* dw, int n_chunks, int kn,
             int Cin, int Cout, cudaStream_t stream) {
  const long long total = (long long)Cout * Cin * kn;
  wgrad_finalize_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      partial, dw, n_chunks, kn, Cin, Cout);
  return (int)cudaGetLastError();
}

int launch_wgrad_f32(const void* x, const void* g, float* partial, float* dw,
                     int B, int H, int W, int Cin, int Cout, int kn,
                     const hg::Geometry& geo, int rows_per_chunk,
                     int n_chunks, const int* plan, cudaStream_t stream) {
  int err;
  const int ci_blk = Cin <= 8 ? 8 : Cin <= 16 ? 16 : 32;
  const int co_blk = Cout <= 32 ? 32 : 64;
#define HG_WGRAD_CASE(CIB, COB)                                             \
  if (ci_blk == CIB && co_blk == COB)                                       \
    err = launch_partial<CIB, COB>(x, g, partial, B, H, W, Cin, Cout, kn,   \
                                   geo, rows_per_chunk, n_chunks, plan,     \
                                   stream);
  HG_WGRAD_CASE(8, 32)
  else HG_WGRAD_CASE(8, 64)
  else HG_WGRAD_CASE(16, 32)
  else HG_WGRAD_CASE(16, 64)
  else HG_WGRAD_CASE(32, 32)
  else HG_WGRAD_CASE(32, 64)
  else return -1;
#undef HG_WGRAD_CASE
  if (err) return err;
  return finalize(partial, dw, n_chunks, kn, Cin, Cout, stream);
}

// The bf16 partial pass: a block takes kTapsBlk taps, or the one tap of a
// one-tap kernel (a 1 x 1 conv), on the patch of the rows its taps read.
int launch_wgrad_bf16(const void* x, const void* g, float* partial,
                      float* dw, int B, int H, int W, int Cin, int Cout,
                      int kn, const hg::Geometry& table, int rows_per_chunk,
                      int n_chunks, cudaStream_t stream) {
  hg::RowMap rmap{};
  const hg::Geometry geo = hg::compact_rows(table, kn, &rmap);
  int err;
#define HG_WGRAD_MMA(N)                                                    \
  (kn == 1 ? launch_mma<N, 1>(x, g, partial, B, H, W, Cin, Cout, kn, geo,   \
                              rmap, rows_per_chunk, n_chunks, stream)       \
           : launch_mma<N, kTapsBlk>(x, g, partial, B, H, W, Cin, Cout, kn, \
                                     geo, rmap, rows_per_chunk, n_chunks,   \
                                     stream))
  switch (wgrad_mma_n(Cin)) {
    case 8:
      err = HG_WGRAD_MMA(8);
      break;
    case 16:
      err = HG_WGRAD_MMA(16);
      break;
    default:
      err = HG_WGRAD_MMA(32);
  }
#undef HG_WGRAD_MMA
  if (err) return err;
  return finalize(partial, dw, n_chunks, kn, Cin, Cout, stream);
}

}  // namespace

// x: (B, H, W, Cin) and g: (B, H, W, Cout), both of `dtype` (0 = float32,
// 1 = bfloat16); taps: host (2, kn, 2) int32 (the forward table);
// partial: float32 scratch (n_chunks, kn, Cin, Cout) with n_chunks =
// ceil(B * H / rows_per_chunk); dw: float32 (Cout, Cin, kn).  The partial
// pass's grid: float32, n_chunks x ceil(kn / taps a block) x
// ceil(Cin / CIB) * ceil(Cout / COB); bfloat16, n_chunks x ceil(kn / 7) x
// ceil(Cout / 64) * ceil(Cin / N) (conv_stack.py::_wgrad_tile mirrors
// both).  plan: float32, 5 host ints, the block the wrapper planned (CIB,
// COB, taps a block, stages, shared bytes: conv_stack.py::
// _wgrad_f32_plan), refused where this entry plans another; bfloat16,
// null.  Returns the first non-zero cudaGetLastError() of its launches, or
// -1 for arguments or a plan the kernels do not take.
extern "C" int hg_hex_conv_wgrad(const void* x, const void* g, void* partial,
                                 void* dw, int dtype, int B, int H, int W,
                                 int Cin, int Cout, int kn, const void* taps,
                                 int rows_per_chunk, int n_chunks,
                                 const int* plan, void* stream) {
  if (kn < 1 || kn > kMaxTaps || B < 1 || H < 1 || W < 1 || Cin < 1 ||
      Cout < 1 || rows_per_chunk < 1 || n_chunks < 1 ||
      (long long)B * H > 0x7fffffffLL ||
      (long long)n_chunks !=
          ((long long)B * H + rows_per_chunk - 1) / rows_per_chunk ||
      (dtype == 0) != (plan != nullptr))
    return -1;
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<float*>(partial);
  auto d = static_cast<float*>(dw);
  if (dtype == 0)
    return launch_wgrad_f32(
        x, g, p, d, B, H, W, Cin, Cout, kn,
        hg::make_geometry(static_cast<const int*>(taps), kn),
        rows_per_chunk, n_chunks, plan, s);
  if (dtype == 1)
    return launch_wgrad_bf16(
        x, g, p, d, B, H, W, Cin, Cout, kn,
        hg::make_geometry(static_cast<const int*>(taps), kn),
        rows_per_chunk, n_chunks, s);
  return -1;
}
