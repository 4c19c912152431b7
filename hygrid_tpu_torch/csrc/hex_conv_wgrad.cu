// hex_conv_wgrad: the weight gradient of one stride-1 'same' hex conv layer,
//
//   dW[co, ci, t] = sum_{b, o, j} x[b, o + dr[q][t], j + dc[q][t], ci]
//                                 * g[b, o, j, co],     q = o % 2,
//
// x the layer's NHWC input, g the cotangent of its pre-activation, zero
// outside the image, accumulated in float32.
//
// Replaces: the dL/dM half of hygrid_tpu/kernels/conv_pallas.py::
// _stack_layer_bwd_kernel (per-slot x_blk^T @ g matmuls on Kronecker-packed
// planes, summed over the sequential batch grid in VMEM).  Its dL/dx half
// is hex_conv_layer.cu's conv pass with the adjoint tap table.
//
// What bounds it: arithmetic.  At HexCNN-small's 512^2 b=32 shapes the six
// layers' dW are about 120 GFLOP, reduced over up to B*H*W = 2.1 M pixels
// per (tap, ci, co): no block can see a whole reduction.  On a TPU the grid
// is sequential and the sum stays in VMEM; here blocks run in any order, so
// the reduction is two deterministic passes with no float atomics:
//   1. wgrad_partial_kernel, grid (chunk of image rows, tap, channel tile):
//      a block walks its rows KP pixels at a time, stages the tap-shifted
//      x (KP x CIB) and g (KP x COB) in shared memory, and each of its 256
//      threads accumulates a 4 x 4 (ci, co) register tile in f32 over its
//      slice of the pixels.  The slices are folded in a fixed order through
//      shared memory and written to partial[chunk][t][ci][co].
//   2. wgrad_finalize_kernel folds the chunks in chunk order into
//      dW (Cout, Cin, kn).
// The FMAs run on the CUDA cores; tensor cores are later work.
#include "hex_common.cuh"

namespace {

using hg::kMaxTaps;
using hg::TapTable;
using hg::to_f32;

constexpr int KP = 64;          // pixels staged per step
constexpr int TI = 4;           // input channels per thread
constexpr int TO = 4;           // output channels per thread
constexpr int kThreads = 256;

template <typename T, int CIB, int COB>
__global__ void __launch_bounds__(kThreads)
wgrad_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
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
    const T* grow = g + r * W * Cout;
    const T* xrow = x + (r - o + xi) * W * Cin;
    for (int j0 = 0; j0 < W; j0 += KP) {
      __syncthreads();
      for (int e = tid; e < KP * COB; e += kThreads) {
        const int c = e % COB, j = j0 + e / COB, co = co0 + c;
        gs[e] = (j < W && co < Cout) ? to_f32(grow[(long long)j * Cout + co])
                                     : 0.f;
      }
      for (int e = tid; e < KP * CIB; e += kThreads) {
        const int c = e % CIB, j = j0 + e / CIB + dc, ci = ci0 + c;
        xs[e] = (j >= 0 && j < W && ci < Cin)
                    ? to_f32(xrow[(long long)j * Cin + ci]) : 0.f;
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

// dw[co][ci][t] = sum over chunks, in chunk order, of partial[chunk][t][ci][co]
__global__ void wgrad_finalize_kernel(const float* __restrict__ partial,
                                      float* __restrict__ dw, int n_chunks,
                                      int kn, int Cin, int Cout) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)Cout * Cin * kn) return;
  const int t = (int)(e % kn);
  const int ci = (int)((e / kn) % Cin);
  const int co = (int)(e / ((long long)kn * Cin));
  const long long stride = (long long)kn * Cin * Cout;
  const float* p = partial + ((long long)t * Cin + ci) * Cout + co;
  float v = 0.f;
  for (int k = 0; k < n_chunks; ++k) v += p[k * stride];
  dw[e] = v;
}

template <typename T, int CIB, int COB>
int launch_partial(const void* x, const void* g, float* partial, int B, int H,
                   int W, int Cin, int Cout, int kn, const TapTable& taps,
                   int rows_per_chunk, int n_chunks, cudaStream_t stream) {
  const int tiles = ((Cin + CIB - 1) / CIB) * ((Cout + COB - 1) / COB);
  if (tiles > 65535) return -1;
  wgrad_partial_kernel<T, CIB, COB><<<dim3(n_chunks, kn, tiles), kThreads, 0,
                                      stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partial, H, W, Cin,
      Cout, (long long)B * H, taps, rows_per_chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wgrad(const void* x, const void* g, float* partial, float* dw,
                 int B, int H, int W, int Cin, int Cout, int kn,
                 const TapTable& taps, int rows_per_chunk, int n_chunks,
                 cudaStream_t stream) {
  int err;
  const int ci_blk = Cin <= 4 ? 4 : (Cin <= 32 ? 32 : 64);
  const int co_blk = Cout <= 32 ? 32 : 64;
#define HG_WGRAD_CASE(CIB, COB)                                              \
  if (ci_blk == CIB && co_blk == COB)                                        \
    err = launch_partial<T, CIB, COB>(x, g, partial, B, H, W, Cin, Cout, kn, \
                                      taps, rows_per_chunk, n_chunks, stream);
  HG_WGRAD_CASE(4, 32)
  else HG_WGRAD_CASE(4, 64)
  else HG_WGRAD_CASE(32, 32)
  else HG_WGRAD_CASE(32, 64)
  else HG_WGRAD_CASE(64, 32)
  else HG_WGRAD_CASE(64, 64)
  else return -1;
#undef HG_WGRAD_CASE
  if (err) return err;
  const long long total = (long long)Cout * Cin * kn;
  wgrad_finalize_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      partial, dw, n_chunks, kn, Cin, Cout);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, H, W, Cin) and g: (B, H, W, Cout), both of `dtype` (0 = float32,
// 1 = bfloat16); taps: host (2, kn, 2) int32 (the forward table);
// partial: float32 scratch (n_chunks, kn, Cin, Cout) with n_chunks =
// ceil(B * H / rows_per_chunk); dw: float32 (Cout, Cin, kn).  Returns the
// first non-zero cudaGetLastError() of its launches, or -1 for arguments
// the kernels do not take.
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
  const TapTable table = hg::make_tap_table(static_cast<const int*>(taps), kn);
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<float*>(partial);
  auto d = static_cast<float*>(dw);
  if (dtype == 0)
    return launch_wgrad<float>(x, g, p, d, B, H, W, Cin, Cout, kn, table,
                               rows_per_chunk, n_chunks, s);
  if (dtype == 1)
    return launch_wgrad<__nv_bfloat16>(x, g, p, d, B, H, W, Cin, Cout, kn,
                                       table, rows_per_chunk, n_chunks, s);
  return -1;
}
