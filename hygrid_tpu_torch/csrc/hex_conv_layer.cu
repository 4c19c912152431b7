// hex_conv_layer: one stride-1 'same' hex convolution layer on NHWC data,
// with bias, an optional norm (GroupNorm or per-channel affine) and ReLU.
//
// Replaces: hygrid_tpu/kernels/conv_pallas.py::_stack_layer_kernel, launched
// per layer by _stack_impl.  The TPU kernel packs Q = 128/C pixels into the
// 128 lanes, splits rows into even/odd planes with zero margins and runs
// Kronecker-expanded matmuls on the MXU; none of that is needed here.  This
// kernel reads plain NHWC activations and zero-pads at all four edges
// itself.
//
// Geometry: for output-row parity q = o % 2 and flat tap t, output pixel
// (o, j) reads input (o + dr[q][t], j + dc[q][t]), zero outside the image.
// The (2, kn, 2) tap table is derived in numpy from the hex kernel's row
// layout and the c0e/c0o column offsets (nn/functional.py::hex_tap_table)
// and passed in by value as a kernel parameter.
//
// What bounds it: arithmetic.  The six HexCNN-small layers at 512^2 input
// and b=32 are about 122 GFLOP per request on at most 268 MB of f32
// activations: well above the memory balance point.  This first version
// runs the FMAs on the CUDA cores, not the tensor cores: one block is one
// tile of hex_common.cuh::conv_tile (64 pixels of a row x 32 output
// channels; each of its 128 threads accumulates 4 pixels x 4 channels in
// f32).  At Cout = 16 half of the block's threads compute only padding
// channels; hex_conv_fused_stack.cu takes a 16-channel tile.  An implicit
// GEMM on wgmma/TMA is later work.
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
// from B otherwise, so the 2W-channel concatenation is never written and
// every other part of the pass, the weights (kn, Ca+Cb, Cout) included, is
// the unsplit layer's.  It moves A and B once each, as the unsplit layer
// moves their concatenation, and is bit-equal to it.
//
// The backward's dL/dx (kernels/conv_stack.py::hex_conv_layer_dgrad) is
// this conv pass alone, run with the adjoint tap table
// (nn/functional.py::hex_adjoint_tap_table), the weights transposed to
// (kn, Cout, Cin), no bias, norm or ReLU: it replaces the dx half of
// conv_pallas.py::_stack_layer_bwd_kernel.  The dW half is
// hex_conv_wgrad.cu.
#include "hex_common.cuh"

namespace {

using hg::kChanT;
using hg::kConvThreads;
using hg::kMaxTaps;
using hg::kTileP;
using hg::Geometry;
using hg::store;

constexpr int COB = 32;                              // output channels per block
constexpr int PT = hg::ConvTile<COB>::kPT;           // 4 pixels per thread
constexpr int kPixLanes = hg::ConvTile<COB>::kPixLanes;  // 16

// kSplit: the layer's input is the channel concatenation of x (B, H, W, Ca)
// and x2 (B, H, W, Cin - Ca) (see hg::conv_tile); otherwise x2 and Ca are
// not read.
template <typename Tin, typename Tout, bool kSplit>
__global__ void __launch_bounds__(kConvThreads)
hex_conv_kernel(const Tin* __restrict__ x, const Tin* __restrict__ x2, int Ca,
                const float* __restrict__ w,
                const float* __restrict__ bias, const float* __restrict__ scale,
                const float* __restrict__ shift, Tout* __restrict__ out,
                int H, int W, int Cin, int Cout, int kn,
                const __grid_constant__ hg::TapTable taps, int r_lo, int n_rows,
                int c_lo, int n_cols, int relu) {
  extern __shared__ __align__(16) float smem[];
  const int n_cob = (Cout + COB - 1) / COB;
  const int b = blockIdx.z / n_cob;
  const int co0 = (blockIdx.z % n_cob) * COB;
  const int o = blockIdx.y;
  const int w0 = blockIdx.x * kTileP;
  const int tp = threadIdx.x % kPixLanes;
  const int tc = threadIdx.x / kPixLanes;

  float acc[PT][kChanT];
  if constexpr (kSplit) {
    const long long pix0 = (long long)b * H * W;   // the sample's first pixel
    hg::conv_tile<COB, false, true>(
        x + pix0 * Ca, w, smem, H, W, Cin, Cout, kn, taps, r_lo, n_rows,
        c_lo, n_cols, o, w0, co0, true, acc, x2 + pix0 * (Cin - Ca), Ca);
  } else {
    hg::conv_tile<COB>(x + (long long)b * H * W * Cin, w, smem, H, W, Cin,
                       Cout, kn, taps, r_lo, n_rows, c_lo, n_cols, o, w0, co0,
                       true, acc);
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
      float v = acc[i][j];
      if (bias) v += bias[co];
      if (scale) v = fmaf(v, scale[co], shift[co]);
      if (relu) v = fmaxf(v, 0.f);
      store(op + co, v);
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

// x2 non-null selects the split instantiation (input channels [0, Ca) from
// x, [Ca, Cin) from x2).
template <typename Tin, typename Tout>
int launch_conv(const void* x, const void* x2, int Ca, const float* w,
                const float* bias, const float* scale, const float* shift,
                void* out, int B, int H, int W, int Cin, int Cout, int kn,
                const Geometry& g, int relu, cudaStream_t stream) {
  const size_t smem = hg::conv_tile_smem(g, kn, COB);
  auto kernel = x2 ? hex_conv_kernel<Tin, Tout, true>
                   : hex_conv_kernel<Tin, Tout, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_cob = (Cout + COB - 1) / COB;
  dim3 grid((W + kTileP - 1) / kTileP, H, B * n_cob);
  kernel<<<grid, kConvThreads, smem, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(x2), Ca, w, bias,
      scale, shift, static_cast<Tout*>(out), H, W, Cin, Cout, kn, g.taps,
      g.r_lo, g.n_rows, g.c_lo, g.n_cols, relu);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_layer(const void* x, const void* x2, int Ca, const float* w,
                 const float* bias, const float* scale, const float* shift,
                 const float* gamma, const float* beta, int gn_groups,
                 float eps, float* y, float* partial, float* stats,
                 int n_chunks, void* out, int B, int H, int W, int Cin,
                 int Cout, int kn, const Geometry& g, int relu,
                 cudaStream_t stream) {
  if (gn_groups == 0)
    return launch_conv<T, T>(x, x2, Ca, w, bias, scale, shift, out, B, H, W,
                             Cin, Cout, kn, g, relu, stream);
  int err = launch_conv<T, float>(x, x2, Ca, w, bias, nullptr, nullptr, y, B,
                                  H, W, Cin, Cout, kn, g, 0, stream);
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
// (0 = float32, 1 = bfloat16); w: (kn, Cin, Cout) float32; taps: host
// (2, kn, 2) int32.  bias/scale/shift/gamma/beta: float32 (Cout,) or null.
// gn_groups > 0 selects GroupNorm and needs the float32 scratch buffers
// y (B, H, W, Cout), partial (B, n_chunks, gn_groups, 2) and
// stats (B, gn_groups, 2).  x2 non-null is the split layer (the
// counterpart of _stack_layer_kernel's split=True, conv_pallas.py:838-871):
// x is (B, H, W, Ca) with input channels [0, Ca), x2 (B, H, W, Cin - Ca)
// with [Ca, Cin), 0 < Ca < Cin, and w still the unsplit (kn, Cin, Cout).
// Returns the first non-zero cudaGetLastError() of its launches, or -1 for
// arguments the kernels do not take.
extern "C" int hg_hex_conv_layer(
    const void* x, const void* x2, int Ca, const void* w, const void* bias,
    const void* scale, const void* shift, const void* gamma, const void* beta,
    int gn_groups, float eps, void* y, void* partial, void* stats,
    int n_chunks, void* out, int dtype, int B, int H, int W, int Cin,
    int Cout, int kn, const void* taps, int relu, void* stream) {
  if (kn < 1 || kn > kMaxTaps || B < 1 || H < 1 || W < 1 || Cin < 1 ||
      Cout < 1 || H > 65535 || (long long)B * ((Cout + COB - 1) / COB) > 65535)
    return -1;
  if (x2 && (Ca < 1 || Ca >= Cin)) return -1;
  if (gn_groups < 0 || (gn_groups > 0 && (Cout % gn_groups || Cout > 1024 ||
                                           n_chunks < 1 || !y || !partial ||
                                           !stats || !gamma || !beta)))
    return -1;
  if ((scale == nullptr) != (shift == nullptr)) return -1;
  const Geometry g = hg::make_geometry(static_cast<const int*>(taps), kn);
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (dtype == 0)
    return launch_layer<float>(
        x, x2, Ca, f(w), f(bias), f(scale), f(shift), f(gamma), f(beta),
        gn_groups, eps, static_cast<float*>(y), static_cast<float*>(partial),
        static_cast<float*>(stats), n_chunks, out, B, H, W, Cin, Cout, kn, g,
        relu, s);
  if (dtype == 1)
    return launch_layer<__nv_bfloat16>(
        x, x2, Ca, f(w), f(bias), f(scale), f(shift), f(gamma), f(beta),
        gn_groups, eps, static_cast<float*>(y), static_cast<float*>(partial),
        static_cast<float*>(stats), n_chunks, out, B, H, W, Cin, Cout, kn, g,
        relu, s);
  return -1;
}
