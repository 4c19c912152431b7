// hex_conv_fused_stack: a whole uniform-width, norm-free stack of stride-1
// 'same' hex conv layers (each: conv, optional bias, optional ReLU) in one
// launch.
//
// Replaces: hygrid_tpu/kernels/conv_pallas.py::_fused_stack_kernel (launched
// by _stack_impl for fused=True).  The TPU kernel runs the stack for one
// batch element per grid step with the activations in VMEM scratch and all
// layers' Kronecker-expanded weights resident, so no activation between
// layers touches HBM.  None of the lane packing is needed here.
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel), its grid
// sized to the blocks that fit on the card at once.  Blocks stride over the
// tiles of a layer (batch element, output row, 64-pixel strip, channel
// block), then wait at a grid-wide barrier (cooperative_groups'
// grid.sync()) before the next layer.  Layer l reads one of two ping-pong
// scratch buffers and writes the other; layer 0 reads x and the last layer
// writes out.  Between layers the activations are rounded to the working
// dtype, as the TPU kernel stores them in dtype scratch.  The batch runs in
// groups sized by the caller so that the two scratch buffers stay in the
// 50 MB L2 (the Hopper counterpart of keeping them in VMEM).
//
// The conv body is hex_common.cuh::conv_tile, the one hex_conv_layer.cu
// runs, with a tile of 16 output channels when C <= 16 (hex_conv_layer's 32
// would leave half of each block idle at C = 16) and 32 otherwise.  The
// accumulation order per output does not depend on the tile, so the stack
// equals chained hex_conv_layer launches bit for bit.  Where one input
// chunk holds every channel (C <= 16), a block stages a layer's weights once
// and keeps them for all its tiles of that layer.
//
// What bounds it: arithmetic.  The P-512 stack (b=16, 256^2, C=16, 11
// layers) is 41 GFLOP on 67 MB of input, output and weights; the FMAs run on
// the CUDA cores.  Tensor cores and a shared-memory stack tile with halo
// recompute are later work.
#include <cooperative_groups.h>

#include "hex_common.cuh"

namespace cg = cooperative_groups;

namespace {

using hg::kChanT;
using hg::kChunkC;
using hg::kConvThreads;
using hg::kMaxTaps;
using hg::kTileP;
using hg::Geometry;
using hg::store;

constexpr int kMaxLayers = 64;

template <typename T, int COB>
__global__ void __launch_bounds__(kConvThreads)
hex_conv_fused_stack_kernel(const T* __restrict__ x, T* __restrict__ out,
                            T* buf0, T* buf1, const float* __restrict__ w,
                            const float* __restrict__ bias,
                            unsigned long long bias_bits,
                            unsigned long long relu_bits, int L, int B,
                            int group, int H, int W, int C, int kn,
                            const __grid_constant__ hg::TapTable taps,
                            int r_lo, int n_rows, int c_lo, int n_cols) {
  constexpr int PT = hg::ConvTile<COB>::kPT;
  constexpr int kPixLanes = hg::ConvTile<COB>::kPixLanes;
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int n_strips = (W + kTileP - 1) / kTileP;
  const int n_cob = (C + COB - 1) / COB;
  const long long plane = (long long)H * W * C;
  const long long layer_w = (long long)kn * C * C;
  const int tp = threadIdx.x % kPixLanes;
  const int tc = threadIdx.x / kPixLanes;
  const bool one_chunk = C <= kChunkC;  // then COB = 16: one channel block

  for (int g0 = 0; g0 < B; g0 += group) {
    const int gb = B - g0 < group ? B - g0 : group;
    const long long tiles = (long long)gb * H * n_strips * n_cob;
    for (int l = 0; l < L; ++l) {
      // layer l - 1 wrote buf0 when l - 1 is even
      const T* src = l == 0 ? x + g0 * plane : (l % 2 ? buf0 : buf1);
      T* dst = l == L - 1 ? out + g0 * plane : (l % 2 ? buf1 : buf0);
      const float* wl = w + l * layer_w;
      const bool has_bias = (bias_bits >> l) & 1ull;
      const bool relu = (relu_bits >> l) & 1ull;
      bool staged = false;
      for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int strip = (int)(tile % n_strips);
        long long rest = tile / n_strips;
        const int co0 = (int)(rest % n_cob) * COB;
        rest /= n_cob;
        const int o = (int)(rest % H);
        const long long b = rest / H;
        const int w0 = strip * kTileP;
        float acc[PT][kChanT];
        hg::conv_tile<COB>(src + b * plane, wl, smem, H, W, C, C, kn, taps,
                           r_lo, n_rows, c_lo, n_cols, o, w0, co0,
                           !(staged && one_chunk), acc);
        staged = true;
#pragma unroll
        for (int i = 0; i < PT; ++i) {
          const int pix = w0 + tp + i * kPixLanes;
          if (pix >= W) continue;
          T* op = dst + b * plane + ((long long)o * W + pix) * C;
#pragma unroll
          for (int j = 0; j < kChanT; ++j) {
            const int co = co0 + tc * kChanT + j;
            if (co >= C) continue;
            float v = acc[i][j];
            if (has_bias) v += bias[l * C + co];
            if (relu) v = fmaxf(v, 0.f);
            store(op + co, v);
          }
        }
      }
      // the next layer (or the next group's first) reads what this one
      // wrote, or overwrites what it read
      if (l < L - 1 || g0 + group < B) grid.sync();
    }
  }
}

template <typename T, int COB>
int launch_fused(const void* x, void* out, void* buf0, void* buf1,
                 const float* w, const float* bias,
                 unsigned long long bias_bits, unsigned long long relu_bits,
                 int L, int B, int group, int H, int W, int C, int kn,
                 const Geometry& g, cudaStream_t stream) {
  auto kernel = hex_conv_fused_stack_kernel<T, COB>;
  const size_t smem = hg::conv_tile_smem(g, kn, COB);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kConvThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (!coop || per_sm < 1 || sms < 1) return -2;
  const long long tiles = (long long)group * H * ((W + kTileP - 1) / kTileP) *
                          ((C + COB - 1) / COB);
  const long long resident = (long long)per_sm * sms;
  const int grid = (int)(tiles < resident ? tiles : resident);

  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  T* b0 = static_cast<T*>(buf0);
  T* b1 = static_cast<T*>(buf1);
  hg::TapTable taps = g.taps;
  int r_lo = g.r_lo, n_rows = g.n_rows, c_lo = g.c_lo, n_cols = g.n_cols;
  void* args[] = {&xp, &op, &b0, &b1, &w, &bias, &bias_bits, &relu_bits,
                  &L, &B, &group, &H, &W, &C, &kn, &taps, &r_lo, &n_rows,
                  &c_lo, &n_cols};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(grid), dim3(kConvThreads), args,
                                    smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(const void* x, void* out, void* buf0, void* buf1,
                 const float* w, const float* bias,
                 unsigned long long bias_bits, unsigned long long relu_bits,
                 int L, int B, int group, int H, int W, int C, int kn,
                 const Geometry& g, cudaStream_t stream) {
  if (C <= 16)
    return launch_fused<T, 16>(x, out, buf0, buf1, w, bias, bias_bits,
                               relu_bits, L, B, group, H, W, C, kn, g, stream);
  return launch_fused<T, 32>(x, out, buf0, buf1, w, bias, bias_bits,
                             relu_bits, L, B, group, H, W, C, kn, g, stream);
}

}  // namespace

// The stack.  x and out: (B, H, W, C) of `dtype` (0 = float32,
// 1 = bfloat16); buf0, buf1: (group, H, W, C) scratch of the same dtype;
// w: (L, kn, C, C) float32, layer l's
// (kn, Cin, Cout) block at l * kn * C * C; bias: (L, C) float32, read for
// the layers whose bit is set in bias_bits (may be null when none is);
// relu_bits: ReLU after layer l when bit l is set; taps: host (2, kn, 2)
// int32.  Returns 0, the first CUDA error, -1 for arguments the kernel does
// not take, or -2 when the device cannot run the cooperative launch.
extern "C" int hg_hex_conv_fused_stack(
    const void* x, void* out, void* buf0, void* buf1, const void* w,
    const void* bias, unsigned long long bias_bits,
    unsigned long long relu_bits, int dtype, int L, int B, int group, int H,
    int W, int C, int kn, const void* taps, void* stream) {
  if (kn < 1 || kn > kMaxTaps || L < 2 || L > kMaxLayers || B < 1 ||
      group < 1 || H < 1 || W < 1 || C < 1 || !buf0 || !buf1 ||
      (bias_bits && !bias))
    return -1;
  const Geometry g = hg::make_geometry(static_cast<const int*>(taps), kn);
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (dtype == 0)
    return launch_dtype<float>(x, out, buf0, buf1, f(w), f(bias), bias_bits,
                               relu_bits, L, B, group, H, W, C, kn, g, s);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(x, out, buf0, buf1, f(w), f(bias),
                                       bias_bits, relu_bits, L, B, group, H,
                                       W, C, kn, g, s);
  return -1;
}
