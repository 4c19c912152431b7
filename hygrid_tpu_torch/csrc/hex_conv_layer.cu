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
// conv pass (hex_conv_fma_kernel) runs on the CUDA cores,
// hex_common.cuh::conv_tile: a block of 256 threads is 4 or 8 output rows x 64 columns x COB = 64, 32 or 16
// output channels (conv_tile_plan), each thread 8 pixels x 8 channels in
// f32 FMAs, the next input chunk copied in with cp.async while this one
// multiplies: TF32 would not hold the 1e-5 agreement with the reference.
//
// GroupNorm (norm "gn", Cout <= 2048; above 1024 a multiple of 4, so that a
// thread of the apply pass holds a vector of 4 or 8 channels): the TPU
// kernel holds the layer's pre-activations
// in VMEM and normalises them in place; here they do not fit in a block, so
// the conv pass writes them, once, and two small passes follow:
//   1. the conv pass's epilogue writes the f32 pre-activation y (+bias) and,
//      from the same registers, the sums of y and y^2 of each output row of
//      the block per segment of seg = gcd(Cout / G, N) output channels (a
//      segment lies in one group and one block) over its valid pixels only:
//      a tree over the thread's pixels, the lanes of a warp (shuffles), the
//      warps (bf16) and the segment's channels (shared memory), written to a
//      fixed place per (sample, output row, column tile, segment): no
//      atomics, so repeated launches and the split layer (the same block
//      geometry) are bit-equal;
//   2. gn_stats_kernel folds a (sample, group)'s sums in a fixed order into
//      mean and rstd as the TPU kernel does (conv_pallas.py:1774-1786):
//      E[y^2] - mean^2 clamped at 0, over the valid pixels x channels per
//      group only, eps added before rsqrt;
//   3. gn_apply_kernel reads y once more, 16 bytes a load, and writes
//      act(fmaf(y, scale, shift)) in the working dtype in 16- or 8-byte
//      stores, scale = rstd * gamma and shift = beta - mean * scale held in
//      registers for the thread's fixed channels (hg::GnLayout).
// So y crosses device memory twice (written, read), where it crossed three
// times with a separate statistics pass.  Without GN, the conv pass applies
// bias, the per-channel affine and ReLU in its epilogue and writes the
// working dtype directly (the kStats = false instantiations); an affine
// layer whose backward will run also writes the float32 pre-activation from
// the same registers (`pre`), as the GN layer keeps its y, so that the
// backward (conv_stack.py::affine_relu_backward, then the dgrad and dW
// passes below) reads the values the forward normalised.  The GN layer's
// backward is gn_backward.cu.
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
#include <numeric>
#include <type_traits>

#include "hex_common.cuh"

namespace {

using hg::kConvThreads;
using hg::kF32Pix;
using hg::kF32Threads;
using hg::kMaxTaps;
using hg::kTileP;
using hg::Geometry;
using hg::store;

__device__ __forceinline__ float with_bias(float v, int co,
                                           const float* __restrict__ bias) {
  return bias ? v + bias[co] : v;
}

// the epilogue after the bias: the per-channel affine and ReLU
__device__ __forceinline__ float post(float v, int co,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ shift,
                                      int relu) {
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

// The stats epilogue's last steps: red holds the block's per-channel sums
// of y (red[0, kN)) and y^2 (red[kN, 2 kN)); each segment of seg (a power
// of 2) consecutive channels is folded as a tree, and the segment sums of
// the channels below Cout go to part, the block's (sample, row, tile) row of
// (Cout / seg) pairs.
template <int kN>
__device__ __forceinline__ void gn_segment_sums(float* red, int seg, int co0,
                                                int Cout,
                                                float* __restrict__ part) {
  for (int st = seg / 2; st > 0; st /= 2) {
    __syncthreads();
    for (int ch = threadIdx.x; ch < kN; ch += kConvThreads)
      if ((ch & (seg - 1)) < st) {
        red[ch] += red[ch + st];
        red[kN + ch] += red[kN + ch + st];
      }
  }
  __syncthreads();
  for (int k = threadIdx.x; k * seg < kN; k += kConvThreads) {
    const int c = co0 + k * seg;
    if (c < Cout) {
      part[2 * (c / seg)] = red[k * seg];
      part[2 * (c / seg) + 1] = red[kN + k * seg];
    }
  }
}

// The float32 stats epilogue's last steps: red holds [kRows][2][kN], each
// output row's per-channel sums of y and y^2; each segment of seg (a power
// of 2) consecutive channels is folded as a tree, and the segment sums of
// the channels below Cout of the rows below H go to the row's entry of
// gn_part (B, H, tiles, Cout / seg, 2).
template <int kN, int kRows>
__device__ __forceinline__ void gn_row_segment_sums(
    float* red, int seg, int b, int o0, int H, int co0, int Cout,
    float* __restrict__ gn_part) {
  for (int st = seg / 2; st > 0; st /= 2) {
    __syncthreads();
    for (int e = threadIdx.x; e < kRows * kN; e += kF32Threads) {
      const int r = e / kN, ch = e % kN;
      if ((ch & (seg - 1)) < st) {
        red[2 * r * kN + ch] += red[2 * r * kN + ch + st];
        red[(2 * r + 1) * kN + ch] += red[(2 * r + 1) * kN + ch + st];
      }
    }
  }
  __syncthreads();
  const int n_seg = kN / seg;
  for (int e = threadIdx.x; e < kRows * n_seg; e += kF32Threads) {
    const int r = e / n_seg, k = e % n_seg;
    const int c = co0 + k * seg, o = o0 + r;
    if (c < Cout && o < H) {
      float* part = gn_part + (((long long)b * H + o) * gridDim.x +
                               blockIdx.x) * 2 * (Cout / seg);
      part[2 * (c / seg)] = red[2 * r * kN + k * seg];
      part[2 * (c / seg) + 1] = red[(2 * r + 1) * kN + k * seg];
    }
  }
}

// The bfloat16 conv pass: kN output channels per block, the tensor-core
// tile's N (hg::conv_tile_mma), one output row (blockIdx.y).  kSplit: the
// layer's input is the channel concatenation of x (B, H, W, Ca) and x2
// (B, H, W, Cin - Ca); otherwise x2 and Ca are not read.  w: the packed
// weights; vec: see hg::stage_patch.  kStats (GN layers: Tout float32, no
// scale or ReLU): the epilogue also writes the block's segment sums of y and
// y^2 to gn_part (B, H, tiles, Cout / seg, 2); otherwise gn_part and seg
// are not read.  pre (not kStats, may be null): the float32 pre-activation
// y (+bias) of the same pixels, (B, H, W, Cout), written beside out (the
// affine layer's forward keeps it for its backward).
template <int kN, typename Tin, typename Tout, bool kSplit, bool kStats>
__global__ void __launch_bounds__(kConvThreads)
hex_conv_kernel(const Tin* __restrict__ x, const Tin* __restrict__ x2, int Ca,
                const Tin* __restrict__ w,
                const float* __restrict__ bias, const float* __restrict__ scale,
                const float* __restrict__ shift, Tout* __restrict__ out,
                float* __restrict__ pre,
                int H, int W, int Cin, int Cout, int kn,
                const __grid_constant__ hg::TapTable taps,
                const __grid_constant__ hg::RowMap rows, int r_lo, int n_rows,
                int c_lo, int n_cols, int relu, int vec,
                float* __restrict__ gn_part, int seg) {
  extern __shared__ __align__(16) float smem[];
  const int n_cob = (Cout + kN - 1) / kN;
  const int b = blockIdx.z / n_cob;
  const int co0 = (blockIdx.z % n_cob) * kN;
  const int w0 = blockIdx.x * kTileP;

  static_assert(std::is_same<Tin, __nv_bfloat16>::value,
                "the float32 pass is hex_conv_fma_kernel");
  const int o = blockIdx.y;
  float* part = nullptr;   // this block's row of segment sums
  if constexpr (kStats)
    part = gn_part + (((long long)b * H + o) * gridDim.x + blockIdx.x) *
                         2 * (Cout / seg);
  const long long pix0 = (long long)b * H * W;   // the sample's first pixel
  float acc[kN / 2];
  hg::conv_tile_mma<kN, kSplit>(
      x + pix0 * (kSplit ? Ca : Cin), kSplit ? x2 + pix0 * (Cin - Ca) : x,
      Ca, w, reinterpret_cast<uint4*>(smem), H, W, Cin, Cout, kn, taps,
      rows, r_lo, n_rows, c_lo, n_cols, o, w0, co0, vec != 0, acc);
  const int lane = threadIdx.x % 32;
  const bool pairs = Cout % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pix = w0 + 16 * (threadIdx.x / 32) + lane / 4 + 8 * h;
    if (pix >= W) continue;
    const long long at = ((pix0 + (long long)o * W) + pix) * Cout;
    Tout* op = out + at;
    float* pp = pre ? pre + at : nullptr;
#pragma unroll
    for (int i = 0; i < kN / 8; ++i) {
      const int co = co0 + 8 * i + 2 * (lane % 4);
      if (co >= Cout) continue;
      const float y0 = with_bias(acc[4 * i + 2 * h], co, bias);
      const float v0 = post(y0, co, scale, shift, relu);
      if (co + 1 >= Cout) {
        store(op + co, v0);
        if (pp) pp[co] = y0;
        continue;
      }
      const float y1 = with_bias(acc[4 * i + 2 * h + 1], co + 1, bias);
      const float v1 = post(y1, co + 1, scale, shift, relu);
      if (pairs) {
        store2(op + co, v0, v1);
        if (pp) store2(pp + co, y0, y1);
      } else {
        store(op + co, v0);
        store(op + co + 1, v1);
        if (pp) {
          pp[co] = y0;
          pp[co + 1] = y1;
        }
      }
    }
  }
  if constexpr (kStats) {
    // per channel: the thread's two pixels, then the 8 lanes that share
    // lane % 4 (shuffles), then the four warps ([2][4 warps][kN] in the
    // free staging buffers: conv_tile_mma ends on a barrier)
    float* red = smem;
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int i = 0; i < kN / 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int co = co0 + 8 * i + 2 * (lane % 4) + j;
        const float bv = bias && co < Cout ? bias[co] : 0.f;
        float s = 0.f, ss = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pix = w0 + 16 * warp + lane / 4 + 8 * h;
          const float v = pix < W ? acc[4 * i + 2 * h + j] + bv : 0.f;
          s += v;
          ss = fmaf(v, v, ss);
        }
#pragma unroll
        for (int off = 4; off < 32; off *= 2) {
          s += __shfl_xor_sync(0xffffffffu, s, off);
          ss += __shfl_xor_sync(0xffffffffu, ss, off);
        }
        if (lane < 4) {
          red[warp * kN + 8 * i + 2 * lane + j] = s;
          red[(4 + warp) * kN + 8 * i + 2 * lane + j] = ss;
        }
      }
    __syncthreads();
    for (int ch = threadIdx.x; ch < kN; ch += kConvThreads) {
      const float s = (red[ch] + red[kN + ch]) +
                      (red[2 * kN + ch] + red[3 * kN + ch]);
      const float ss = (red[4 * kN + ch] + red[5 * kN + ch]) +
                       (red[6 * kN + ch] + red[7 * kN + ch]);
      red[ch] = s;               // this thread's column only
      red[kN + ch] = ss;
    }
    gn_segment_sums<kN>(red, seg, co0, Cout, part);
  }
}

// The float32 conv pass on the CUDA cores (hg::conv_tile): kN = the
// tile's COB output channels per block, F32Tile<kN>::kRows output rows
// (blockIdx.y) x 64 columns, kF32Threads threads; vec: the tile's flags
// (hg::kF32VecX ...); kGroups: the taps in groups of tg, n_rows the most
// rows one reaches (hg::F32Plan; without it tg is kn).  The other
// arguments as hex_conv_kernel's, float32 throughout.
template <int kN, bool kSplit, bool kStats, bool kGroups>
__global__ void __launch_bounds__(kF32Threads, 2)
hex_conv_fma_kernel(const float* __restrict__ x, const float* __restrict__ x2,
                    int Ca, const float* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ scale,
                    const float* __restrict__ shift, float* __restrict__ out,
                    float* __restrict__ pre, int H, int W, int Cin, int Cout,
                    int kn, int tg, const __grid_constant__ hg::TapTable taps,
                    int r_lo, int n_rows, int c_lo, int n_cols, int relu,
                    int vec, float* __restrict__ gn_part, int seg) {
  extern __shared__ __align__(16) float smem[];
  const int n_cob = (Cout + kN - 1) / kN;
  const int b = blockIdx.z / n_cob;
  const int co0 = (blockIdx.z % n_cob) * kN;
  const int w0 = blockIdx.x * kTileP;
  using T = hg::F32Tile<kN>;
  constexpr int CT = T::kCT;
  const int o0 = blockIdx.y * T::kRows;
  const int cl = threadIdx.x % 8;
  const int tc = (threadIdx.x / 8) % T::kCL;
  const int row = (threadIdx.x / 8) / T::kCL;
  const int o = o0 + row;
  const long long pix0 = (long long)b * H * W;   // the sample's first pixel
  float acc[kF32Pix][CT];
  hg::conv_tile<kN, kSplit, kGroups>(
      x + pix0 * (kSplit ? Ca : Cin), w, smem, H, W, Cin, Cout, kn, tg,
      taps, r_lo, n_rows, c_lo, n_cols, o0, w0, co0, true, vec, acc,
      kSplit ? x2 + pix0 * (Cin - Ca) : nullptr, Ca);

  // thread channels co0 + h kN / 2 + 4 tc + j, 16-byte stores where Cout
  // is a multiple of 4 and the outputs are aligned
  const bool vec_out = (vec & hg::kF32VecOut) != 0;
  if (o < H) {
#pragma unroll
    for (int i = 0; i < kF32Pix; ++i) {
      const int pix = w0 + cl + 8 * i;
      if (pix >= W) continue;
      const long long at = ((pix0 + (long long)o * W) + pix) * Cout;
#pragma unroll
      for (int h = 0; h < CT / 4; ++h) {
        const int co = co0 + h * (kN / 2) + 4 * tc;
        if (co >= Cout) continue;
        float y[4], v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          y[j] = co + j < Cout ? with_bias(acc[i][4 * h + j], co + j, bias)
                               : 0.f;
          v[j] = co + j < Cout ? post(y[j], co + j, scale, shift, relu)
                               : 0.f;
        }
        if (vec_out) {
          *reinterpret_cast<float4*>(out + at + co) =
              make_float4(v[0], v[1], v[2], v[3]);
          if (pre)
            *reinterpret_cast<float4*>(pre + at + co) =
                make_float4(y[0], y[1], y[2], y[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (co + j < Cout) {
              store(out + at + co + j, v[j]);
              if (pre) pre[at + co + j] = y[j];
            }
        }
      }
    }
  }
  if constexpr (kStats) {
    // per output row and channel: the thread's 8 pixels as a tree, then
    // the row's 8 column lanes (shuffles within the warp); [kRows][2][kN]
    // in the staging buffers, free once conv_tile's last barrier passed
    float* red = smem;
#pragma unroll
    for (int k = 0; k < CT; ++k) {
      const int ch = (k / 4) * (kN / 2) + 4 * tc + k % 4;
      const int co = co0 + ch;
      const float bv = bias && co < Cout ? bias[co] : 0.f;
      float v[kF32Pix];
#pragma unroll
      for (int i = 0; i < kF32Pix; ++i)
        v[i] = o < H && w0 + cl + 8 * i < W ? acc[i][k] + bv : 0.f;
      float s = ((v[0] + v[1]) + (v[2] + v[3])) +
                ((v[4] + v[5]) + (v[6] + v[7]));
      float ss = (fmaf(v[0], v[0], v[1] * v[1]) +
                  fmaf(v[2], v[2], v[3] * v[3])) +
                 (fmaf(v[4], v[4], v[5] * v[5]) +
                  fmaf(v[6], v[6], v[7] * v[7]));
#pragma unroll
      for (int off = 1; off < 8; off *= 2) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
      }
      if (cl == 0) {
        red[2 * row * kN + ch] = s;
        red[(2 * row + 1) * kN + ch] = ss;
      }
    }
    gn_row_segment_sums<kN, T::kRows>(red, seg, b, o0, H, co0, Cout,
                                      gn_part);
  }
}

// Per (sample, group), one block: the fold of the conv epilogue's segment
// sums into stats (B, G, 2) = (mean, rstd).  Thread t sums the (row, tile)
// entries t, t + 256, ... in order, the group's segments each, then a tree;
// count = valid pixels x channels per group.
__global__ void __launch_bounds__(256)
gn_stats_kernel(const float* __restrict__ part, float* __restrict__ stats,
                int n_tiles, int n_seg, int seg_per_group, int G, float count,
                float eps) {
  __shared__ float red[2][256];
  const int b = blockIdx.x / G, g = blockIdx.x % G, t = threadIdx.x;
  float s = 0.f, ss = 0.f;
  for (int e = t; e < n_tiles; e += 256) {
    const float* p = part + (((long long)b * n_tiles + e) * n_seg +
                             (long long)g * seg_per_group) * 2;
    for (int k = 0; k < seg_per_group; ++k) {
      s += p[2 * k];
      ss += p[2 * k + 1];
    }
  }
  red[0][t] = s;
  red[1][t] = ss;
  for (int st = 128; st > 0; st /= 2) {
    __syncthreads();
    if (t < st) {
      red[0][t] += red[0][t + st];
      red[1][t] += red[1][t + st];
    }
  }
  if (t == 0) {
    const float mean = red[0][0] / count;
    const float var = fmaxf(red[1][0] / count - mean * mean, 0.f);
    stats[2 * blockIdx.x] = mean;
    stats[2 * blockIdx.x + 1] = rsqrtf(var + eps);
  }
}

// Block (chunk, sample) in hg::GnLayout: out = act(fmaf(y, scale, shift))
// over the chunk's px pixels of NHWC y (B, HW, C).
template <int V, typename Tout>
__global__ void __launch_bounds__(V == 1 ? 1024 : 256)
gn_apply_kernel(const float* __restrict__ y, const float* __restrict__ stats,
                const float* __restrict__ gamma,
                const float* __restrict__ beta, Tout* __restrict__ out,
                long long HW, int C, int G, int px, int relu) {
  const int cvs = C / V, k = blockDim.x / cvs;
  const int c = (threadIdx.x % cvs) * V;
  const int b = blockIdx.y, cpg = C / G;
  float sc[V], sh[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float* st = stats + 2 * ((long long)b * G + (c + i) / cpg);
    sc[i] = st[1] * gamma[c + i];
    // rounded twice, not fused, so that the backward's ReLU mask
    // (gn_backward.cu) and the plain versions rebuild the same shift
    sh[i] = __fsub_rn(beta[c + i], __fmul_rn(st[0], sc[i]));
  }
  const long long p0 = (long long)blockIdx.x * px;
  const long long p1 = p0 + px < HW ? p0 + px : HW;
  const long long base = (long long)b * HW * C + c;
  for (long long p = p0 + threadIdx.x / cvs; p < p1; p += k) {
    float v[V];
    hg::load_vec<V>(y + base + p * C, v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      v[i] = fmaf(v[i], sc[i], sh[i]);
      if (relu) v[i] = fmaxf(v[i], 0.f);
    }
    hg::store_vec<V>(out + base + p * C, v);
  }
}

// A block: kConvThreads threads on one output row (bfloat16), or
// kF32Threads on F32Tile<kN>::kRows rows (float32, its taps in groups of
// tg reaching at most g.n_rows rows: hg::F32Plan).
template <int kN, typename Tin, typename Tout, bool kStats>
int launch_conv_n(const void* x, const void* x2, int Ca, const void* w,
                  const float* bias, const float* scale, const float* shift,
                  void* out, float* pre, int B, int H, int W, int Cin, int Cout, int kn,
                  int tg, const Geometry& g, const hg::RowMap& rmap, int relu,
                  int vec, size_t smem, float* gn_part, int seg,
                  cudaStream_t stream) {
  constexpr bool f32 = std::is_same<Tin, float>::value;
  auto kernel = [&] {
    if constexpr (f32) {
      if (tg < kn)
        return x2 ? hex_conv_fma_kernel<kN, true, kStats, true>
                  : hex_conv_fma_kernel<kN, false, kStats, true>;
      return x2 ? hex_conv_fma_kernel<kN, true, kStats, false>
                : hex_conv_fma_kernel<kN, false, kStats, false>;
    } else
      return x2 ? hex_conv_kernel<kN, Tin, Tout, true, kStats>
                : hex_conv_kernel<kN, Tin, Tout, false, kStats>;
  }();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = f32 ? hg::f32_tile_rows(kN) : 1;
  const int n_cob = (Cout + kN - 1) / kN;
  dim3 grid((W + kTileP - 1) / kTileP, (H + rows - 1) / rows, B * n_cob);
  auto xt = static_cast<const Tin*>(x), x2t = static_cast<const Tin*>(x2);
  auto wt = static_cast<const Tin*>(w);
  auto ot = static_cast<Tout*>(out);
  if constexpr (f32)
    kernel<<<grid, kF32Threads, smem, stream>>>(
        xt, x2t, Ca, wt, bias, scale, shift, ot, pre, H, W, Cin, Cout, kn, tg,
        g.taps, g.r_lo, g.n_rows, g.c_lo, g.n_cols, relu, vec, gn_part, seg);
  else
    kernel<<<grid, kConvThreads, smem, stream>>>(
        xt, x2t, Ca, wt, bias, scale, shift, ot, pre, H, W, Cin, Cout, kn,
        g.taps, rmap, g.r_lo, g.n_rows, g.c_lo, g.n_cols, relu, vec, gn_part,
        seg);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// x2 non-null selects the split instantiation (input channels [0, Ca) from
// x, [Ca, Cin) from x2).  n: the tile's output channels (the float32
// tile's COB or the bfloat16 tile's N).  kStats: the GN layer's conv pass
// (Tout float32), writing segment sums to gn_part.  g: the tap table's
// geometry; in bfloat16 hg::compact_rows', with its row map rmap.
template <typename Tin, typename Tout, bool kStats>
int launch_conv(const void* x, const void* x2, int Ca, const void* w,
                const float* bias, const float* scale, const float* shift,
                void* out, float* pre, int B, int H, int W, int Cin, int Cout, int kn,
                const Geometry& g, const hg::RowMap& rmap, int relu, int n,
                float* gn_part, int seg, cudaStream_t stream) {
  if constexpr (std::is_same<Tin, float>::value) {
    const hg::F32Plan p = hg::conv_tile_plan(g, kn, Cin, Cout);
    if (p.cob != n) return -1;
    const int vec =
        (Cin % 4 == 0 && (!x2 || Ca % 4 == 0) && aligned16(x) &&
                 (!x2 || aligned16(x2)) ? hg::kF32VecX : 0) |
        (Cout % 4 == 0 && aligned16(w) ? hg::kF32VecW : 0) |
        (Cout % 4 == 0 && aligned16(out) && (!pre || aligned16(pre))
             ? hg::kF32VecOut : 0) |
        (p.stages == 2 ? hg::kF32TwoStages : 0);
    Geometry band = g;
    band.n_rows = p.band;
    switch (n) {
#define HG_CONV_F32(N)                                                      \
  case N:                                                                   \
    return launch_conv_n<N, Tin, Tout, kStats>(                             \
        x, x2, Ca, w, bias, scale, shift, out, pre, B, H, W, Cin, Cout, kn, \
        p.taps, band, rmap, relu, vec, p.smem, gn_part, seg, stream);
      HG_CONV_F32(16)
      HG_CONV_F32(32)
      HG_CONV_F32(64)
#undef HG_CONV_F32
      default:
        return -1;
    }
  } else {
    // 16-byte copies where every unit of 8 channels lies whole in one
    // aligned input
    const int vec = Cin % 8 == 0 && (!x2 || Ca % 8 == 0) && aligned16(x) &&
                    (!x2 || aligned16(x2));
    const size_t smem = hg::conv_tile_mma_smem(g, kn, n, Cin);
    switch (n) {
#define HG_CONV_N(N)                                                        \
  case N:                                                                   \
    return launch_conv_n<N, Tin, Tout, kStats>(                             \
        x, x2, Ca, w, bias, scale, shift, out, pre, B, H, W, Cin, Cout, kn, \
        kn, g, rmap, relu, vec, smem, gn_part, seg, stream);
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

// the GN pass's pixels a block: 8 rows of the thread layout
constexpr int kApplyPasses = 8;

template <typename T>
int launch_layer(const void* x, const void* x2, int Ca, const void* w,
                 const float* bias, const float* scale, const float* shift,
                 const float* gamma, const float* beta, int gn_groups,
                 float eps, float* y, float* part, long long n_part,
                 float* stats, void* out, int B, int H, int W, int Cin,
                 int Cout, int kn, const Geometry& g, const hg::RowMap& rmap,
                 int relu, int n, cudaStream_t stream) {
  if (gn_groups == 0)
    return launch_conv<T, T, false>(x, x2, Ca, w, bias, scale, shift, out, y,
                                    B, H, W, Cin, Cout, kn, g, rmap, relu, n,
                                    nullptr, 0, stream);
  const int cpg = Cout / gn_groups;
  const int seg = std::gcd(cpg, n);
  const int tiles = (W + kTileP - 1) / kTileP;
  if (n_part != 2LL * B * H * tiles * (Cout / seg)) return -1;
  const hg::GnLayout lay = hg::gn_layout(Cout, aligned16(y) && aligned16(out));
  // a thread a vector: more than 1024 channels need vectors of 4 or 8
  if (lay.threads() > 1024) return -1;
  int err = launch_conv<T, float, true>(x, x2, Ca, w, bias, nullptr, nullptr,
                                        y, nullptr, B, H, W, Cin, Cout, kn, g,
                                        rmap, 0, n, part, seg, stream);
  if (err) return err;
  const long long HW = (long long)H * W;
  gn_stats_kernel<<<B * gn_groups, 256, 0, stream>>>(
      part, stats, H * tiles, Cout / seg, cpg / seg, gn_groups,
      (float)(HW * cpg), eps);
  if ((err = (int)cudaGetLastError())) return err;
  const int px = lay.k * kApplyPasses;
  const dim3 grid((unsigned)((HW + px - 1) / px), B);
  return hg::dispatch_v(lay.V, [&](auto v) {
    gn_apply_kernel<decltype(v)::value, T><<<grid, lay.threads(), 0, stream>>>(
        y, stats, gamma, beta, static_cast<T*>(out), HW, Cout, gn_groups, px,
        relu);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// One layer.  x: (B, H, W, Cin) and out: (B, H, W, Cout), both of `dtype`
// (0 = float32, 1 = bfloat16); w, of `dtype` too: for float32 the (kn, Cin,
// Cout) weights, for bfloat16 the same weights rounded to bf16 and packed
// as (ceil(Cin / 16), kn, 2, Cout, 8) (the unit [c, t, g, co, :] holds
// input channels 16 c + 8 g .. + 7 of tap t for output channel co, zero
// past Cin; conv_stack.py::_pack_mma_weights), 16-byte aligned; taps: host
// (2, kn, 2) int32.  bias/scale/shift/gamma/beta: float32 (Cout,) or null.
// gn_groups > 0 selects GroupNorm and needs the float32 buffers y (B, H, W,
// Cout), the pre-activation (kept for the backward), part (B, H,
// ceil(W / 64), Cout / seg, 2) with seg = gcd(Cout / gn_groups, N), n_part
// its floats, and stats (B, gn_groups, 2), mean and rstd (kept for the
// backward).  Without GN, y non-null (B, H, W, Cout) float32 receives the
// pre-activation (conv + bias) beside out: the affine layer's forward keeps
// it for its backward.  x2 non-null is the split layer (the
// counterpart of _stack_layer_kernel's split=True, conv_pallas.py:838-871):
// x is (B, H, W, Ca) with input channels [0, Ca), x2 (B, H, W, Cin - Ca)
// with [Ca, Cin), 0 < Ca < Cin, and w still the unsplit layer's.  The grid
// has B x ceil(Cout / N) blocks in z, N the output channels of a block:
// hg::conv_tile_plan's COB in float32, hg::conv_tile_mma_n's choice in
// bfloat16 (conv_stack.py::_tile_n mirrors both).
// Returns the first non-zero cudaGetLastError() of its launches, or -1 for
// arguments the kernels do not take.
extern "C" int hg_hex_conv_layer(
    const void* x, const void* x2, int Ca, const void* w, const void* bias,
    const void* scale, const void* shift, const void* gamma, const void* beta,
    int gn_groups, float eps, void* y, void* part, void* stats,
    long long n_part, void* out, int dtype, int B, int H, int W, int Cin,
    int Cout, int kn, const void* taps, int relu, void* stream) {
  if (kn < 1 || kn > kMaxTaps || B < 1 || H < 1 || W < 1 || Cin < 1 ||
      Cout < 1 || H > 65535 || (dtype != 0 && dtype != 1))
    return -1;
  if (x2 && (Ca < 1 || Ca >= Cin)) return -1;
  if (gn_groups < 0 || (gn_groups > 0 && (Cout % gn_groups || Cout > 2048 ||
                                           !y || !part || !stats || !gamma ||
                                           !beta)))
    return -1;
  if ((scale == nullptr) != (shift == nullptr)) return -1;
  if (dtype == 1 && !aligned16(w)) return -1;
  hg::RowMap rmap{};
  Geometry g = hg::make_geometry(static_cast<const int*>(taps), kn);
  if (dtype == 1) g = hg::compact_rows(g, kn, &rmap);
  const int n = dtype == 0 ? hg::conv_tile_plan(g, kn, Cin, Cout).cob
                           : hg::conv_tile_mma_n(g, kn, Cin, Cout);
  if (n == 0) return -1;
  if ((long long)B * ((Cout + n - 1) / n) > 65535) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (dtype == 0)
    return launch_layer<float>(
        x, x2, Ca, w, f(bias), f(scale), f(shift), f(gamma), f(beta),
        gn_groups, eps, static_cast<float*>(y), static_cast<float*>(part),
        n_part, static_cast<float*>(stats), out, B, H, W, Cin, Cout, kn, g,
        rmap, relu, n, s);
  return launch_layer<__nv_bfloat16>(
      x, x2, Ca, w, f(bias), f(scale), f(shift), f(gamma), f(beta),
      gn_groups, eps, static_cast<float*>(y), static_cast<float*>(part),
      n_part, static_cast<float*>(stats), out, B, H, W, Cin, Cout, kn, g,
      rmap, relu, n, s);
}
