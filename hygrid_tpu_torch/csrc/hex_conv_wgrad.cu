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
// reach (the rows r_lo .. r_hi around it x 64 + tap width columns) in
// shared memory, both as 16-byte units of 8 channels of one pixel, as NHWC
// holds them.  8 consecutive pixels of one channel group are then the
// MN-major ("transposed") core matrix that bf16 wgmma reads for A and B:
// A = g^T with co contiguous, B = the x window with ci contiguous, K =
// pixels.  So a tap's shifted window is a descriptor offset into the one
// staged patch, as in hex_common.cuh::conv_tile_mma; nothing is staged per
// tap.  Each block holds up to kTapsBlk taps' 64 x N f32 accumulators in
// registers (7 x 16 a thread at N = 32); more taps take more blocks.  The
// next two steps are copied with cp.async (16-byte units, zero fill at the
// image edges) while this one multiplies; where a unit is not whole in
// memory (Cin or Cout not a multiple of 8, as at the 3-channel stem) it is
// staged element by element into the same layout.  The wrapper cuts the
// rows into fixed chunks, about 792 blocks in all (conv_stack.py::
// _wgrad_chunks): fewer, longer blocks than the float32 pass's write fewer
// partial sums.  The chunks depend on the shapes alone, so every card
// folds the same partial sums and gives the same bits.
//
// float32, the partial pass on the CUDA cores (wgrad_partial_kernel): grid
// (chunk, tap, channel tile); a block walks its rows KP pixels at a time,
// stages the tap-shifted x (KP x CIB) and g (KP x COB) in shared memory,
// and each of its 256 threads accumulates a 4 x 4 (ci, co) register tile
// in f32 over its slice of the pixels; the slices are folded in a fixed
// order through shared memory.
#include "hex_common.cuh"

namespace {

using hg::kMaxTaps;
using hg::TapTable;

constexpr int KP = 64;          // pixels staged per step
constexpr int TI = 4;           // input channels per thread
constexpr int TO = 4;           // output channels per thread
constexpr int kThreads = 256;

template <int CIB, int COB>
__global__ void __launch_bounds__(kThreads)
wgrad_partial_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     float* __restrict__ partial, int H, int W, int Cin,
                     int Cout, long long rows,
                     const __grid_constant__ TapTable taps,
                     int rows_per_chunk) {
  constexpr int NI = CIB / TI, NO = COB / TO;
  constexpr int PS = kThreads / (NI * NO);   // pixel slices
  static_assert(PS * NI * NO == kThreads && KP % PS == 0, "tile shape");
  constexpr int kStage = KP * (CIB + COB);
  constexpr int kRed = PS > 1 ? PS * CIB * COB : 0;
  __shared__ __align__(16) float smem[kStage > kRed ? kStage : kRed];
  float* xs = smem;                          // [KP][CIB]
  float* gs = smem + KP * CIB;               // [KP][COB]

  const int chunk = blockIdx.x, t = blockIdx.y, kn = gridDim.y;
  const int n_co = (Cout + COB - 1) / COB;
  const int ci0 = (blockIdx.z / n_co) * CIB;
  const int co0 = (blockIdx.z % n_co) * COB;
  const int tid = threadIdx.x;
  const int to = tid % NO;
  const int ti = (tid / NO) % NI;
  const int s = tid / (NO * NI);

  float acc[TI][TO];
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int k = 0; k < TO; ++k) acc[i][k] = 0.f;

  const long long r0 = (long long)chunk * rows_per_chunk;
  const long long r1 = r0 + rows_per_chunk < rows ? r0 + rows_per_chunk : rows;
  for (long long r = r0; r < r1; ++r) {
    const int o = (int)(r % H);
    const int xi = o + taps.dr[o & 1][t];
    if (xi < 0 || xi >= H) continue;         // the same for the whole block
    const int dc = taps.dc[o & 1][t];
    const float* grow = g + r * W * Cout;
    const float* xrow = x + (r - o + xi) * W * Cin;
    for (int j0 = 0; j0 < W; j0 += KP) {
      __syncthreads();
      for (int e = tid; e < KP * COB; e += kThreads) {
        const int c = e % COB, j = j0 + e / COB, co = co0 + c;
        gs[e] = (j < W && co < Cout) ? grow[(long long)j * Cout + co] : 0.f;
      }
      for (int e = tid; e < KP * CIB; e += kThreads) {
        const int c = e % CIB, j = j0 + e / CIB + dc, ci = ci0 + c;
        xs[e] = (j >= 0 && j < W && ci < Cin) ? xrow[(long long)j * Cin + ci]
                                              : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int p = s; p < KP; p += PS) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + p * CIB + ti * TI);
        const float4 gv = *reinterpret_cast<const float4*>(gs + p * COB + to * TO);
        const float xa[TI] = {xv.x, xv.y, xv.z, xv.w};
        const float ga[TO] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int i = 0; i < TI; ++i)
#pragma unroll
          for (int k = 0; k < TO; ++k) acc[i][k] = fmaf(xa[i], ga[k], acc[i][k]);
      }
    }
  }

  float* out = partial + ((long long)chunk * kn + t) * Cin * Cout;
  if constexpr (PS == 1) {
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int k = 0; k < TO; ++k) {
        const int ci = ci0 + ti * TI + i, co = co0 + to * TO + k;
        if (ci < Cin && co < Cout) out[(long long)ci * Cout + co] = acc[i][k];
      }
    return;
  }
  // fold the pixel slices in slice order
  __syncthreads();
  float* red = smem;                         // [PS][CIB][COB]
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int k = 0; k < TO; ++k)
      red[(s * CIB + ti * TI + i) * COB + to * TO + k] = acc[i][k];
  __syncthreads();
  for (int e = tid; e < CIB * COB; e += kThreads) {
    float v = 0.f;
    for (int k = 0; k < PS; ++k) v += red[k * CIB * COB + e];
    const int ci = ci0 + e / COB, co = co0 + e % COB;
    if (ci < Cin && co < Cout) out[(long long)ci * Cout + co] = v;
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

// grid (chunk, tap group of kTapsBlk, output-channel tile x input-channel
// tile).  Shared memory: kMmaStages stages of [8][kGStride] g units (64
// channels x 64 pixels, the channel groups padded apart so the copies do
// not conflict) and [n_rows][N / 8][n_cols] x units.  Step s's MMAs are
// issued, then step s + 2's copies, then the MMAs are waited on: two
// steps' copies are in flight while the tensor cores work.
template <int N>
__global__ void __launch_bounds__(kMmaThreads)
wgrad_mma_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ g,
                 float* __restrict__ partial, int H, int W, int Cin,
                 int Cout, int kn, const __grid_constant__ TapTable taps,
                 int r_lo, int n_rows, int c_lo, int n_cols, long long rows,
                 int rows_per_chunk, int vec_x, int vec_g) {
  constexpr int NG = N / 8;
  extern __shared__ __align__(16) uint4 smem_u[];
  const int g_units = 8 * kGStride;
  const int stage_units = g_units + n_rows * NG * n_cols;
  const int chunk = blockIdx.x;
  const int t0 = blockIdx.y * kTapsBlk;
  const int nt = min(kTapsBlk, kn - t0);
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
      const int xi = o + r_lo + r, xj = j0 + c_lo + c;
      if (ci0 + 8 * cig < Cin)
        stage_unit(xs + (r * NG + cig) * n_cols + c, x,
                   (row - o + xi) * W + xj, Cin, ci0 + 8 * cig,
                   xi >= 0 && xi < H && xj >= 0 && xj < W, vec_x);
    }
    hg::cp_async_commit();
  };

  float acc[kTapsBlk][N / 2];
#pragma unroll
  for (int t = 0; t < kTapsBlk; ++t)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[t][i] = 0.f;

  // a block's last tap group may hold fewer taps: the missing ones repeat
  // its last tap into accumulators that are never stored, so every step
  // issues the same MMAs with no branch among them
  int tap[kTapsBlk];
#pragma unroll
  for (int t = 0; t < kTapsBlk; ++t) tap[t] = t0 + min(t, nt - 1);

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
    for (int t = 0; t < kTapsBlk; ++t) hg::fence_acc(acc[t]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int t = 0; t < kTapsBlk; ++t) {
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
    for (int t = 0; t < kTapsBlk; ++t) hg::fence_acc(acc[t]);
  }

  // acc[t][4 i + 2 h + j]: output channel co0 + 16 warp + lane / 4 + 8 h,
  // input channel ci0 + 8 i + 2 (lane % 4) + j
  const int lane = tid % 32;
#pragma unroll
  for (int t = 0; t < kTapsBlk; ++t) {
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

template <int N>
int launch_mma(const void* x, const void* g, float* partial, int B, int H,
               int W, int Cin, int Cout, int kn, const hg::Geometry& geo,
               int rows_per_chunk, int n_chunks, cudaStream_t stream) {
  const long long tiles =
      (long long)((Cout + kMmaM - 1) / kMmaM) * ((Cin + N - 1) / N);
  if (tiles > 65535) return -1;
  const size_t smem = wgrad_mma_smem(N, geo.n_rows, mma_patch_cols(geo));
  if (smem > (size_t)hg::kMmaMaxSmem) return -1;
  auto kernel = wgrad_mma_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_x = Cin % 8 == 0 && aligned(x);
  const int vec_g = Cout % 8 == 0 && aligned(g);
  dim3 grid(n_chunks, (kn + kTapsBlk - 1) / kTapsBlk, (unsigned)tiles);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(g), partial, H, W, Cin, Cout, kn,
      geo.taps, geo.r_lo, geo.n_rows, geo.c_lo, mma_patch_cols(geo),
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

template <int CIB, int COB>
int launch_partial(const void* x, const void* g, float* partial, int B, int H,
                   int W, int Cin, int Cout, int kn, const TapTable& taps,
                   int rows_per_chunk, int n_chunks, cudaStream_t stream) {
  const int tiles = ((Cin + CIB - 1) / CIB) * ((Cout + COB - 1) / COB);
  if (tiles > 65535) return -1;
  wgrad_partial_kernel<CIB, COB><<<dim3(n_chunks, kn, tiles), kThreads, 0,
                                   stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), partial,
      H, W, Cin, Cout, (long long)B * H, taps, rows_per_chunk);
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
                     const TapTable& taps, int rows_per_chunk, int n_chunks,
                     cudaStream_t stream) {
  int err;
  const int ci_blk = Cin <= 4 ? 4 : (Cin <= 32 ? 32 : 64);
  const int co_blk = Cout <= 32 ? 32 : 64;
#define HG_WGRAD_CASE(CIB, COB)                                             \
  if (ci_blk == CIB && co_blk == COB)                                       \
    err = launch_partial<CIB, COB>(x, g, partial, B, H, W, Cin,             \
                                          Cout, kn, taps, rows_per_chunk,   \
                                          n_chunks, stream);
  HG_WGRAD_CASE(4, 32)
  else HG_WGRAD_CASE(4, 64)
  else HG_WGRAD_CASE(32, 32)
  else HG_WGRAD_CASE(32, 64)
  else HG_WGRAD_CASE(64, 32)
  else HG_WGRAD_CASE(64, 64)
  else return -1;
#undef HG_WGRAD_CASE
  if (err) return err;
  return finalize(partial, dw, n_chunks, kn, Cin, Cout, stream);
}

int launch_wgrad_bf16(const void* x, const void* g, float* partial,
                      float* dw, int B, int H, int W, int Cin, int Cout,
                      int kn, const hg::Geometry& geo, int rows_per_chunk,
                      int n_chunks, cudaStream_t stream) {
  int err;
  switch (wgrad_mma_n(Cin)) {
    case 8:
      err = launch_mma<8>(x, g, partial, B, H, W, Cin, Cout, kn, geo,
                          rows_per_chunk, n_chunks, stream);
      break;
    case 16:
      err = launch_mma<16>(x, g, partial, B, H, W, Cin, Cout, kn, geo,
                           rows_per_chunk, n_chunks, stream);
      break;
    default:
      err = launch_mma<32>(x, g, partial, B, H, W, Cin, Cout, kn, geo,
                           rows_per_chunk, n_chunks, stream);
  }
  if (err) return err;
  return finalize(partial, dw, n_chunks, kn, Cin, Cout, stream);
}

}  // namespace

// x: (B, H, W, Cin) and g: (B, H, W, Cout), both of `dtype` (0 = float32,
// 1 = bfloat16); taps: host (2, kn, 2) int32 (the forward table);
// partial: float32 scratch (n_chunks, kn, Cin, Cout) with n_chunks =
// ceil(B * H / rows_per_chunk); dw: float32 (Cout, Cin, kn).  The partial
// pass's grid: float32, n_chunks x kn x ceil(Cin / CIB) * ceil(Cout / COB);
// bfloat16, n_chunks x ceil(kn / 7) x ceil(Cout / 64) * ceil(Cin / N)
// (conv_stack.py::_wgrad_tile mirrors it).  Returns the first non-zero
// cudaGetLastError() of its launches, or -1 for arguments the kernels do
// not take.
extern "C" int hg_hex_conv_wgrad(const void* x, const void* g, void* partial,
                                 void* dw, int dtype, int B, int H, int W,
                                 int Cin, int Cout, int kn, const void* taps,
                                 int rows_per_chunk, int n_chunks,
                                 void* stream) {
  if (kn < 1 || kn > kMaxTaps || B < 1 || H < 1 || W < 1 || Cin < 1 ||
      Cout < 1 || rows_per_chunk < 1 || n_chunks < 1 ||
      (long long)n_chunks !=
          ((long long)B * H + rows_per_chunk - 1) / rows_per_chunk)
    return -1;
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<float*>(partial);
  auto d = static_cast<float*>(dw);
  if (dtype == 0)
    return launch_wgrad_f32(
        x, g, p, d, B, H, W, Cin, Cout, kn,
        hg::make_tap_table(static_cast<const int*>(taps), kn),
        rows_per_chunk, n_chunks, s);
  if (dtype == 1)
    return launch_wgrad_bf16(
        x, g, p, d, B, H, W, Cin, Cout, kn,
        hg::make_geometry(static_cast<const int*>(taps), kn),
        rows_per_chunk, n_chunks, s);
  return -1;
}
