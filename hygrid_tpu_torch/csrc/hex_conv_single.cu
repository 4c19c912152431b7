// hex_conv_single: one stride-1 'valid' hex convolution on NCHW data, any
// input-row parity and dilation (the single-op conv of hex_conv2d).
//
// Replaces: hygrid_tpu/kernels/conv_pallas.py::_conv_kernel (:106, launched
// at :333 by _single_op_impl) and ::_conv_kernel_banded (:127, launched at
// :311 for inputs above _CONV_BAND_THRESHOLD elements).  The TPU kernels
// pack Q = 128/C pixels into the lanes, split the input into even/odd row
// planes, assemble one Kronecker "shift x tap" matrix per (plane, row,
// packed-column shift) and run them on the MXU from VMEM; the banded one
// DMAs row bands of the planes because whole planes outgrow VMEM.  None of
// that is needed here, and one kernel covers both: the card has no VMEM to
// band for, and a block stages only the rows its tile reads.
//
// What it computes: output pixel (o, j) of channel co, with q = o & 1 (even
// rows are the even phase), is sum over taps t and input channels ci of
// w[t][ci][co] * x[ci][o + dr[q][t]][j + dc[q][t]], reads past the last
// column zero.  The tap table is nn/functional.py::hex_valid_tap_table
// (dr = i*d, dc = c0_q[i] + d*k for kernel row i, cell k), passed by value.
// The output extent (Ho, Wo) is hex_conv2d_output_shape's, computed by the
// caller.  Activations are float32 or bfloat16 and the output has their
// dtype; weights are float32 staged as (kn, Cin, Cout); sums are float32.
// The bias is added by the caller after the kernel, in the output dtype, as
// conv_pallas.py:205-206 does.
//
// Design: the block is one tile of hex_common.cuh::conv_tile (64 output
// pixels of a row x 32 output channels, 16 when Cout <= 16), reading NCHW
// with a column-fastest staging walk, so a warp's loads and stores are
// consecutive and no permute to NHWC is needed around it.  The
// accumulation order is the tile's (channel chunks, taps, channels), so on
// an input padded by d*(r-1) the kernel equals hex_conv_layer.cu's 'same'
// conv bit for bit.
//
// What bounds it: arithmetic.  HexCNN-small's five kernel layers at 512^2
// input and b=32 are 119 GFLOP on about 1 GB of f32 activations, well above
// the memory balance point.  This first version runs the FMAs on the CUDA
// cores (as kernel B does, about 11 TFLOP/s); an implicit GEMM on the tensor
// cores is later work.
#include "hex_common.cuh"

namespace {

using hg::kChanT;
using hg::kConvThreads;
using hg::kMaxTaps;
using hg::kTileP;
using hg::Geometry;
using hg::store;

template <typename T, int COB>
__global__ void __launch_bounds__(kConvThreads)
hex_conv_single_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       T* __restrict__ out, int H, int W, int Cin, int Ho,
                       int Wo, int Cout, int kn,
                       const __grid_constant__ hg::TapTable taps, int r_lo,
                       int n_rows, int c_lo, int n_cols) {
  constexpr int PT = hg::ConvTile<COB>::kPT;
  constexpr int kPixLanes = hg::ConvTile<COB>::kPixLanes;
  extern __shared__ __align__(16) float smem[];
  const int n_cob = (Cout + COB - 1) / COB;
  const int b = blockIdx.z / n_cob;
  const int co0 = (blockIdx.z % n_cob) * COB;
  const int o = blockIdx.y;
  const int w0 = blockIdx.x * kTileP;
  const int tp = threadIdx.x % kPixLanes;
  const int tc = threadIdx.x / kPixLanes;
  const long long plane = (long long)H * W;

  float acc[PT][kChanT];
  hg::conv_tile<COB, true>(x + (long long)b * Cin * plane, w, smem, H, W,
                           Cin, Cout, kn, taps, r_lo, n_rows, c_lo, n_cols,
                           o, w0, co0, true, acc);

  const long long oplane = (long long)Ho * Wo;
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int pix = w0 + tp + i * kPixLanes;
    if (pix >= Wo) continue;
#pragma unroll
    for (int j = 0; j < kChanT; ++j) {
      const int co = co0 + tc * kChanT + j;
      if (co >= Cout) continue;
      store(out + ((long long)b * Cout + co) * oplane + (long long)o * Wo + pix,
            acc[i][j]);
    }
  }
}

template <typename T, int COB>
int launch(const void* x, const float* w, void* out, int B, int H, int W,
           int Cin, int Ho, int Wo, int Cout, int kn, const Geometry& g,
           cudaStream_t stream) {
  const size_t smem = hg::conv_tile_smem(g, kn, COB);
  auto kernel = hex_conv_single_kernel<T, COB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_cob = (Cout + COB - 1) / COB;
  dim3 grid((Wo + kTileP - 1) / kTileP, Ho, B * n_cob);
  kernel<<<grid, kConvThreads, smem, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(out), H, W, Cin, Ho, Wo,
      Cout, kn, g.taps, g.r_lo, g.n_rows, g.c_lo, g.n_cols);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(const void* x, const float* w, void* out, int B, int H,
                 int W, int Cin, int Ho, int Wo, int Cout, int kn,
                 const Geometry& g, cudaStream_t stream) {
  if (Cout <= 16)
    return launch<T, 16>(x, w, out, B, H, W, Cin, Ho, Wo, Cout, kn, g, stream);
  return launch<T, 32>(x, w, out, B, H, W, Cin, Ho, Wo, Cout, kn, g, stream);
}

}  // namespace

// One valid conv.  x: (B, Cin, H, W) and out: (B, Cout, Ho, Wo), both of
// `dtype` (0 = float32, 1 = bfloat16), contiguous; w: (kn, Cin, Cout)
// float32; taps: host (2, kn, 2) int32 (hex_valid_tap_table).  Returns 0,
// the first CUDA error, or -1 for arguments the kernel does not take.
extern "C" int hg_hex_conv_single(const void* x, const void* w, void* out,
                                  int dtype, int B, int H, int W, int Cin,
                                  int Ho, int Wo, int Cout, int kn,
                                  const void* taps, void* stream) {
  const int cob = Cout <= 16 ? 16 : 32;
  if (kn < 1 || kn > kMaxTaps || B < 1 || H < 1 || W < 1 || Cin < 1 ||
      Ho < 1 || Wo < 1 || Cout < 1 || Ho > 65535 ||
      (long long)B * ((Cout + cob - 1) / cob) > 65535)
    return -1;
  const Geometry g = hg::make_geometry(static_cast<const int*>(taps), kn);
  auto s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  if (dtype == 0)
    return launch_dtype<float>(x, wf, out, B, H, W, Cin, Ho, Wo, Cout, kn, g,
                               s);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(x, wf, out, B, H, W, Cin, Ho, Wo, Cout,
                                       kn, g, s);
  return -1;
}
