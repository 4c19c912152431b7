// hex_conv_layer: one stride-1 'same' hex convolution layer on NHWC data,
// with bias, an optional norm (GroupNorm or per-channel affine) and ReLU.
//
// Replaces: hygrid_tpu/kernels/conv_pallas.py::_stack_layer_kernel, launched
// per layer by _stack_impl, and its row-banded twin
// _stack_layer_kernel_banded (the same function on planes larger than
// VMEM).  The TPU kernel packs Q = 128/C pixels into the 128 lanes, splits
// rows into even/odd planes with zero margins and runs Kronecker-expanded
// matmuls on the MXU; none of that is needed here.  This kernel reads plain
// NHWC activations and zero-pads at all four edges itself.
//
// Geometry: for output-row parity q = o % 2 and flat tap t, output pixel
// (o, j) reads input (o + dr[q][t], j + dc[q][t]), zero outside the image.
// The (2, kn, 2) tap table is derived in numpy from the hex kernel's row
// layout and the c0e/c0o column offsets (nn/functional.py::hex_tap_table)
// and passed in by value as a kernel parameter.
//
// What bounds it: arithmetic.  The six HexCNN-small layers at 512^2 input
// and b=32 are about 122 GFLOP per request on at most 268 MB of f32
// activations: well above the memory balance point, in bf16 too.  So the
// bfloat16 conv pass runs on the tensor cores: one block is one tile of
// hex_common.cuh::conv_tile_mma, an implicit GEMM of 64 pixels of one row
// x N output channels (16, 32, 64 or 128, from Cout) x K = kn x Cin, each
// tap's A operand a shifted window of one staged patch, wgmma.mma_async
// m64nNk16 bf16 x bf16 -> f32, the next 16-channel chunk copied in with
// cp.async while this one multiplies (see the tile's note for the layout
// and for why wgmma).  Its weights are bf16, as the TPU kernel rounds them
// (_assemble_mats(..., dtype)): for bfloat16 activations `w` is the packed
// bf16 tensor conv_stack.py::_pack_mma_weights builds from the (kn, Cin,
// Cout) weights, so the pointer type of `w` follows `dtype`.  The float32
// conv pass keeps the CUDA-core tile, hex_common.cuh::conv_tile (64 pixels
// x 32 output channels, each of 128 threads accumulating 4 x 4 in f32
// FMAs): TF32 would not hold the 1e-5 agreement with the reference.
//
// GroupNorm (norm "gn"), in three more passes of the same simple kind:
//   1. the conv pass writes the f32 pre-activation (+bias) to scratch;
//   2. gn_partial_kernel sums x and x^2 per (sample, chunk of pixels, group);
//      gn_finalize_kernel folds the chunks into mean and rstd, as the TPU
//      kernel does: E[x^2] - mean^2 clamped at 0, over the valid pixels x
//      channels-per-group only, eps added before rsqrt;
//   3. gn_apply_kernel writes act(x * scale + shift) in the working dtype,
//      scale = rstd * gamma, shift = beta - mean * scale.
// Without GN, the conv pass applies bias, the per-channel affine and ReLU
// in its epilogue and writes the working dtype directly.
//
// Split mode (x2 non-null) replaces _stack_layer_kernel with split=True
// (conv_pallas.py:838-871), the first layer of a UNet decoder's skip-join
// stage: conv(concat(A, B), K) = conv(A, Ka) + conv(B, Kb), then the same
// bias / GN / affine / ReLU.  The TPU kernel runs two Kronecker matmul sets;
// here the conv pass's staging load reads channel c from A when c < Ca and
// from B otherwise (per 8-channel unit, or per element where a unit
// straddles Ca), so the 2W-channel concatenation is never written and
// every other part of the pass, the weights (kn, Ca+Cb, Cout) included, is
// the unsplit layer's.  It moves A and B once each, as the unsplit layer
// moves their concatenation, and is bit-equal to it.
//
// The backward's dL/dx (kernels/conv_stack.py::hex_conv_layer_dgrad) is
// this conv pass alone, run with the adjoint tap table
// (nn/functional.py::hex_adjoint_tap_table), the weights transposed to
// (kn, Cout, Cin), no bias, norm or ReLU: it replaces the dx half of
// conv_pallas.py::_stack_layer_bwd_kernel, and in bfloat16 it runs on the
// same tensor-core tile.  The dW half is hex_conv_wgrad.cu.
#include <type_traits>

#include "hex_common.cuh"

namespace {

using hg::kChanT;
using hg::kConvThreads;
using hg::kMaxTaps;
using hg::kTileP;
using hg::Geometry;
using hg::store;

constexpr int COB = 32;   // float32: output channels per block
constexpr int PT = hg::ConvTile<COB>::kPT;           // 4 pixels per thread
constexpr int kPixLanes = hg::ConvTile<COB>::kPixLanes;  // 16

__device__ __forceinline__ float epilogue(float v, int co,
                                          const float* __restrict__ bias,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ shift,
                                          int relu) {
  if (bias) v += bias[co];
  if (scale) v = fmaf(v, scale[co], shift[co]);
  if (relu) v = fmaxf(v, 0.f);
  return v;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// kN output channels per block: COB for float32 (hg::conv_tile), the
// tensor-core tile's N for bfloat16 (hg::conv_tile_mma).  kSplit: the
// layer's input is the channel concatenation of x (B, H, W, Ca) and x2
// (B, H, W, Cin - Ca); otherwise x2 and Ca are not read.  w: float32
// (kn, Cin, Cout), or for bfloat16 the packed weights; vec: see
// hg::stage_patch (bfloat16 only).
template <int kN, typename Tin, typename Tout, bool kSplit>
__global__ void __launch_bounds__(kConvThreads)
hex_conv_kernel(const Tin* __restrict__ x, const Tin* __restrict__ x2, int Ca,
                const Tin* __restrict__ w,
                const float* __restrict__ bias, const float* __restrict__ scale,
                const float* __restrict__ shift, Tout* __restrict__ out,
                int H, int W, int Cin, int Cout, int kn,
                const __grid_constant__ hg::TapTable taps, int r_lo, int n_rows,
                int c_lo, int n_cols, int relu, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int n_cob = (Cout + kN - 1) / kN;
  const int b = blockIdx.z / n_cob;
  const int co0 = (blockIdx.z % n_cob) * kN;
  const int o = blockIdx.y;
  const int w0 = blockIdx.x * kTileP;

  if constexpr (std::is_same<Tin, __nv_bfloat16>::value) {
    const long long pix0 = (long long)b * H * W;   // the sample's first pixel
    float acc[kN / 2];
    hg::conv_tile_mma<kN, kSplit>(
        x + pix0 * (kSplit ? Ca : Cin), kSplit ? x2 + pix0 * (Cin - Ca) : x,
        Ca, w, reinterpret_cast<uint4*>(smem), H, W, Cin, Cout, kn, taps,
        r_lo, n_rows, c_lo, n_cols, o, w0, co0, vec != 0, acc);
    const int lane = threadIdx.x % 32;
    const bool pairs = Cout % 2 == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pix = w0 + 16 * (threadIdx.x / 32) + lane / 4 + 8 * h;
      if (pix >= W) continue;
      Tout* op = out + ((pix0 + (long long)o * W) + pix) * Cout;
#pragma unroll
      for (int i = 0; i < kN / 8; ++i) {
        const int co = co0 + 8 * i + 2 * (lane % 4);
        if (co >= Cout) continue;
        const float v0 = epilogue(acc[4 * i + 2 * h], co, bias, scale, shift,
                                  relu);
        if (co + 1 >= Cout) {
          store(op + co, v0);
          continue;
        }
        const float v1 = epilogue(acc[4 * i + 2 * h + 1], co + 1, bias, scale,
                                  shift, relu);
        if (pairs) {
          store2(op + co, v0, v1);
        } else {
          store(op + co, v0);
          store(op + co + 1, v1);
        }
      }
    }
  } else {
    const int tp = threadIdx.x % kPixLanes;
    const int tc = threadIdx.x / kPixLanes;
    float acc[PT][kChanT];
    if constexpr (kSplit) {
      const long long pix0 = (long long)b * H * W;
      hg::conv_tile<COB, false, true>(
          x + pix0 * Ca, w, smem, H, W, Cin, Cout, kn, taps, r_lo, n_rows,
          c_lo, n_cols, o, w0, co0, true, acc, x2 + pix0 * (Cin - Ca), Ca);
    } else {
      hg::conv_tile<COB>(x + (long long)b * H * W * Cin, w, smem, H, W, Cin,
                         Cout, kn, taps, r_lo, n_rows, c_lo, n_cols, o, w0,
                         co0, true, acc);
    }

#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const int pix = w0 + tp + i * kPixLanes;
      if (pix >= W) continue;
      Tout* op = out + (((long long)b * H + o) * W + pix) * Cout;
#pragma unroll
      for (int j = 0; j < kChanT; ++j) {
        const int co = co0 + tc * kChanT + j;
        if (co >= Cout) continue;
        store(op + co, epilogue(acc[i][j], co, bias, scale, shift, relu));
      }
    }
  }
}

// Per (chunk of pixels, sample): sums of y and y^2 for each channel group.
// Block (C, lanes): thread (c, l) walks pixels l, l + lanes, ... of the
// chunk at channel c, so a warp reads consecutive channels of a pixel.
__global__ void gn_partial_kernel(const float* __restrict__ y,
                                  float* __restrict__ partial, long long HW,
                                  int C, int G, int n_chunks) {
  extern __shared__ float red[];             // [2][lanes][C]
  const int c = threadIdx.x, l = threadIdx.y, lanes = blockDim.y;
  const int chunk = blockIdx.x, b = blockIdx.y;
  const long long per = (HW + n_chunks - 1) / n_chunks;
  const long long p0 = chunk * per;
  const long long p1 = p0 + per < HW ? p0 + per : HW;
  const float* yb = y + (long long)b * HW * C;
  float s = 0.f, ss = 0.f;
  for (long long p = p0 + l; p < p1; p += lanes) {
    const float v = yb[p * C + c];
    s += v;
    ss = fmaf(v, v, ss);
  }
  red[l * C + c] = s;
  red[(lanes + l) * C + c] = ss;
  __syncthreads();
  const int tid = l * C + c;
  if (tid < G) {
    const int cpg = C / G;
    float gs = 0.f, gss = 0.f;
    for (int k = 0; k < lanes; ++k)
      for (int cc = tid * cpg; cc < (tid + 1) * cpg; ++cc) {
        gs += red[k * C + cc];
        gss += red[(lanes + k) * C + cc];
      }
    float* pp = partial + (((long long)b * n_chunks + chunk) * G + tid) * 2;
    pp[0] = gs;
    pp[1] = gss;
  }
}

__global__ void gn_finalize_kernel(const float* __restrict__ partial,
                                   float* __restrict__ stats, int B, int G,
                                   int n_chunks, float count, float eps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * G) return;
  const int b = i / G, g = i % G;
  float s = 0.f, ss = 0.f;
  for (int k = 0; k < n_chunks; ++k) {
    const float* pp = partial + (((long long)b * n_chunks + k) * G + g) * 2;
    s += pp[0];
    ss += pp[1];
  }
  const float mean = s / count;
  const float var = fmaxf(ss / count - mean * mean, 0.f);
  stats[2 * i] = mean;
  stats[2 * i + 1] = rsqrtf(var + eps);
}

template <typename Tout>
__global__ void gn_apply_kernel(const float* __restrict__ y,
                                const float* __restrict__ stats,
                                const float* __restrict__ gamma,
                                const float* __restrict__ beta,
                                Tout* __restrict__ out, long long HW, int C,
                                int G, long long total, int relu) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int c = (int)(e % C);
  const long long b = e / (HW * C);
  const long long bg = b * G + c / (C / G);
  const float sc = stats[2 * bg + 1] * gamma[c];
  const float sh = beta[c] - stats[2 * bg] * sc;
  float v = fmaf(y[e], sc, sh);
  if (relu) v = fmaxf(v, 0.f);
  store(out + e, v);
}

template <int kN, typename Tin, typename Tout>
int launch_conv_n(const void* x, const void* x2, int Ca, const void* w,
                  const float* bias, const float* scale, const float* shift,
                  void* out, int B, int H, int W, int Cin, int Cout, int kn,
                  const Geometry& g, int relu, int vec, size_t smem,
                  cudaStream_t stream) {
  auto kernel = x2 ? hex_conv_kernel<kN, Tin, Tout, true>
                   : hex_conv_kernel<kN, Tin, Tout, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_cob = (Cout + kN - 1) / kN;
  dim3 grid((W + kTileP - 1) / kTileP, H, B * n_cob);
  kernel<<<grid, kConvThreads, smem, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(x2), Ca,
      static_cast<const Tin*>(w), bias, scale, shift, static_cast<Tout*>(out),
      H, W, Cin, Cout, kn, g.taps, g.r_lo, g.n_rows, g.c_lo, g.n_cols, relu,
      vec);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// x2 non-null selects the split instantiation (input channels [0, Ca) from
// x, [Ca, Cin) from x2).  n: the bfloat16 tile's N.
template <typename Tin, typename Tout>
int launch_conv(const void* x, const void* x2, int Ca, const void* w,
                const float* bias, const float* scale, const float* shift,
                void* out, int B, int H, int W, int Cin, int Cout, int kn,
                const Geometry& g, int relu, int n, cudaStream_t stream) {
  if constexpr (std::is_same<Tin, float>::value) {
    return launch_conv_n<COB, Tin, Tout>(
        x, x2, Ca, w, bias, scale, shift, out, B, H, W, Cin, Cout, kn, g,
        relu, 0, hg::conv_tile_smem(g, kn, COB), stream);
  } else {
    // 16-byte copies where every unit of 8 channels lies whole in one
    // aligned input
    const int vec = Cin % 8 == 0 && (!x2 || Ca % 8 == 0) && aligned16(x) &&
                    (!x2 || aligned16(x2));
    const size_t smem = hg::conv_tile_mma_smem(g, kn, n, Cin);
    switch (n) {
#define HG_CONV_N(N)                                                        \
  case N:                                                                   \
    return launch_conv_n<N, Tin, Tout>(x, x2, Ca, w, bias, scale, shift,    \
                                       out, B, H, W, Cin, Cout, kn, g, relu, \
                                       vec, smem, stream);
      HG_CONV_N(16)
      HG_CONV_N(32)
      HG_CONV_N(64)
      HG_CONV_N(128)
#undef HG_CONV_N
      default:
        return -1;
    }
  }
}

template <typename T>
int launch_layer(const void* x, const void* x2, int Ca, const void* w,
                 const float* bias, const float* scale, const float* shift,
                 const float* gamma, const float* beta, int gn_groups,
                 float eps, float* y, float* partial, float* stats,
                 int n_chunks, void* out, int B, int H, int W, int Cin,
                 int Cout, int kn, const Geometry& g, int relu, int n,
                 cudaStream_t stream) {
  if (gn_groups == 0)
    return launch_conv<T, T>(x, x2, Ca, w, bias, scale, shift, out, B, H, W,
                             Cin, Cout, kn, g, relu, n, stream);
  int err = launch_conv<T, float>(x, x2, Ca, w, bias, nullptr, nullptr, y, B,
                                  H, W, Cin, Cout, kn, g, 0, n, stream);
  if (err) return err;
  const long long HW = (long long)H * W;
  const int lanes = Cout >= 256 ? 1 : 256 / Cout;
  dim3 pblock(Cout, lanes);
  gn_partial_kernel<<<dim3(n_chunks, B), pblock,
                      sizeof(float) * 2 * lanes * Cout, stream>>>(
      y, partial, HW, Cout, gn_groups, n_chunks);
  if ((err = (int)cudaGetLastError())) return err;
  const int bg = B * gn_groups;
  gn_finalize_kernel<<<(bg + 255) / 256, 256, 0, stream>>>(
      partial, stats, B, gn_groups, n_chunks,
      (float)HW * (float)(Cout / gn_groups), eps);
  if ((err = (int)cudaGetLastError())) return err;
  const long long total = (long long)B * HW * Cout;
  gn_apply_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      y, stats, gamma, beta, static_cast<T*>(out), HW, Cout, gn_groups, total,
      relu);
  return (int)cudaGetLastError();
}

}  // namespace

// One layer.  x: (B, H, W, Cin) and out: (B, H, W, Cout), both of `dtype`
// (0 = float32, 1 = bfloat16); w, of `dtype` too: for float32 the (kn, Cin,
// Cout) weights, for bfloat16 the same weights rounded to bf16 and packed
// as (ceil(Cin / 16), kn, 2, Cout, 8) (the unit [c, t, g, co, :] holds
// input channels 16 c + 8 g .. + 7 of tap t for output channel co, zero
// past Cin; conv_stack.py::_pack_mma_weights), 16-byte aligned; taps: host
// (2, kn, 2) int32.  bias/scale/shift/gamma/beta: float32 (Cout,) or null.
// gn_groups > 0 selects GroupNorm and needs the float32 scratch buffers
// y (B, H, W, Cout), partial (B, n_chunks, gn_groups, 2) and
// stats (B, gn_groups, 2).  x2 non-null is the split layer (the
// counterpart of _stack_layer_kernel's split=True, conv_pallas.py:838-871):
// x is (B, H, W, Ca) with input channels [0, Ca), x2 (B, H, W, Cin - Ca)
// with [Ca, Cin), 0 < Ca < Cin, and w still the unsplit layer's.  The grid
// has B x ceil(Cout / N) blocks in z, N the output channels of a block:
// COB in float32, hg::conv_tile_mma_n's choice in bfloat16
// (conv_stack.py::_tile_n mirrors both).
// Returns the first non-zero cudaGetLastError() of its launches, or -1 for
// arguments the kernels do not take.
extern "C" int hg_hex_conv_layer(
    const void* x, const void* x2, int Ca, const void* w, const void* bias,
    const void* scale, const void* shift, const void* gamma, const void* beta,
    int gn_groups, float eps, void* y, void* partial, void* stats,
    int n_chunks, void* out, int dtype, int B, int H, int W, int Cin,
    int Cout, int kn, const void* taps, int relu, void* stream) {
  if (kn < 1 || kn > kMaxTaps || B < 1 || H < 1 || W < 1 || Cin < 1 ||
      Cout < 1 || H > 65535 || (dtype != 0 && dtype != 1))
    return -1;
  if (x2 && (Ca < 1 || Ca >= Cin)) return -1;
  if (gn_groups < 0 || (gn_groups > 0 && (Cout % gn_groups || Cout > 1024 ||
                                           n_chunks < 1 || !y || !partial ||
                                           !stats || !gamma || !beta)))
    return -1;
  if ((scale == nullptr) != (shift == nullptr)) return -1;
  if (dtype == 1 && !aligned16(w)) return -1;
  const Geometry g = hg::make_geometry(static_cast<const int*>(taps), kn);
  const int n = dtype == 0 ? COB : hg::conv_tile_mma_n(g, kn, Cin, Cout);
  if ((long long)B * ((Cout + n - 1) / n) > 65535) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (dtype == 0)
    return launch_layer<float>(
        x, x2, Ca, w, f(bias), f(scale), f(shift), f(gamma), f(beta),
        gn_groups, eps, static_cast<float*>(y), static_cast<float*>(partial),
        static_cast<float*>(stats), n_chunks, out, B, H, W, Cin, Cout, kn, g,
        relu, n, s);
  return launch_layer<__nv_bfloat16>(
      x, x2, Ca, w, f(bias), f(scale), f(shift), f(gamma), f(beta),
      gn_groups, eps, static_cast<float*>(y), static_cast<float*>(partial),
      static_cast<float*>(stats), n_chunks, out, B, H, W, Cin, Cout, kn, g,
      relu, n, s);
}
