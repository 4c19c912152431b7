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
// Schedule: one cooperative launch (cudaLaunchCooperativeKernel), its grid
// sized to the blocks that fit on the card at once.  Blocks stride over the
// tiles of a layer, then wait at a grid-wide barrier (cooperative_groups'
// grid.sync()) before the next layer.  Layer l reads one of two ping-pong
// scratch buffers and writes the other; layer 0 reads x and the last layer
// writes out.  Between layers the activations are rounded to the working
// dtype, as the TPU kernel stores them in dtype scratch.  The batch runs in
// groups sized by the caller so that the two scratch buffers stay in the
// 50 MB L2 (the Hopper counterpart of keeping them in VMEM).
//
// bfloat16 (fused_stack_mma_kernel<N>): the sums of kernel B's tensor-core
// tile, hex_common.cuh::conv_tile_mma, on row bands.  A tile is (sample, a
// band of R output rows, 64 pixels of those rows, N output channels).  Per
// 16-channel chunk the block stages the band's R + n_rows - 1 input rows
// once, in the tile's [row][channel group][column][8 channels] unit layout,
// so the A operand of output row i and tap (dr, dc) is the staged band seen
// from unit row i + dr - r_lo, column dc - c_lo: a descriptor offset by
// whole rows, with each row's own parity's tap table.  The block runs nwg
// warpgroups (one or two); warpgroup g owns rows g * RW .. g * RW + RW - 1
// of the band (RW = 4, 2, 1, 1 for N = 16, 32, 64, 128: 32 or 64 f32
// accumulators a thread) and issues RW x kn wgmma m64nNk16 a chunk.  K is
// walked as (chunk, tap), 16 channels of a chunk inside one MMA, from zeroed
// f32 accumulators, then the epilogue adds the bias and applies ReLU and
// the result is rounded to bf16: kernel B's instruction sequence for every
// output row, so the stack equals chained hex_conv_layer launches bit for
// bit (an output column's sum does not depend on N or on the row's place in
// the band).  The weights are the packed bf16 slabs of conv_stack.py::
// _pack_mma_weights, one per layer, stacked; they are
//   per layer  (weights mode 0): one layer's slab staged once a block at
//              the start of the layer (the P-512 stack: 7 x 2 x 16 units of
//              16 bytes, 3.5 KB);
//   per chunk  (1): the tile's N channels of one chunk staged beside the
//              band, as kernel B does, where one layer does not fit.
// Every layer's slab staged once a launch measured no faster than one
// layer's once a block (0.7408-0.7449 ms against 0.7436-0.7450 ms, the
// P-512 stack alone, NVIDIA H100 80GB HBM3, 700.00 W), so there is no such
// mode.
// Stages (tile, chunk) are double-buffered: the next stage's band (and
// per-chunk weights) is copied in with cp.async while this stage's MMAs
// run, across tile boundaries within a layer.  fused_mma_plan picks N, the
// warpgroups and the weights mode from shared memory alone, and the launch
// reports its choice through `plan`; occupancy then sizes the grid.
//
// float32 (hex_conv_fused_stack_kernel): hex_common.cuh::conv_tile, the
// tile hex_conv_layer.cu's float32 pass runs, with its launch shape and
// shared memory (conv_tile_plan: 256 threads, 8 rows x 64 columns x 16
// output channels where C <= 16, 8 x 64 x 32 where C <= 32, 4 x 64 x 64
// above); where one input chunk holds every channel a block stages a
// layer's weights once for all its tiles of that layer.  Its accumulation
// order per output does not depend on the tile, so it too equals chained
// hex_conv_layer launches bit for bit.  TF32 would not hold the 1e-5
// agreement with the reference.
//
// What bounds it: the P-512 stack (b=16, 256^2, C=16, 11 layers) is 41 GFLOP
// on 67 MB of input, output and weights: 0.042 ms at the bf16 tensor rate
// and 0.020 ms of HBM, so arithmetic bounds it.  What holds the kernel back
// is nearer the L2: every layer reads (R + 2) / R band rows per output row
// and writes its output through the L2 scratch, and at C = 16 each MMA is
// the narrowest the tensor cores take (m64n16k16).  Row bands stage an
// input row once per band instead of three times a row, a layer's weights
// are staged once a block instead of once a tile, and the copy of
// the next stage hides behind this one's MMAs.
#include <cooperative_groups.h>

#include "hex_common.cuh"

namespace cg = cooperative_groups;

namespace {

using hg::kChunkC;
using hg::kConvThreads;
using hg::kF32Pix;
using hg::kF32Threads;
using hg::kMaxTaps;
using hg::kTileP;
using hg::Geometry;
using hg::store;

constexpr int kMaxLayers = 64;
constexpr int kFusedMaxWarpgroups = 2;
constexpr int kWeightsPerLayer = 0, kWeightsPerChunk = 1;

// ---- bfloat16: the tensor-core tile on row bands --------------------------

// output rows of a band each warpgroup owns: RW x N / 2 f32 accumulators
__host__ __device__ constexpr int fused_rw(int n) {
  return n == 16 ? 4 : n == 32 ? 2 : 1;
}

// Shared memory of the bf16 launch, in bytes: two stages of the band (and,
// per chunk, of the tile's weights) and the per-layer slab.
size_t fused_mma_smem(int c, int kn, int n, int nwg, int wmode, int n_rows,
                      int n_cols) {
  const size_t chunks = (c + kChunkC - 1) / kChunkC;
  const size_t npad = (size_t)((c + n - 1) / n) * n;
  const size_t band = (size_t)(nwg * fused_rw(n) + n_rows - 1) * 2 * n_cols;
  const size_t stage = band + (wmode == kWeightsPerChunk ? (size_t)kn * 2 * n
                                                         : 0);
  const size_t slab =
      wmode == kWeightsPerLayer ? chunks * kn * 2 * npad : 0;
  return 16 * (2 * stage + slab);
}

struct FusedPlan {
  int n, nwg, wmode;
  size_t smem;
};

// N: the least of 16, 32, 64, 128 that covers C (128 above), halved while
// nothing fits; for that N the first weights mode (per layer, per chunk)
// and then the most warpgroups (2, 1) whose shared memory fits in a block's
// 227 KB.  n = 0: nothing fits.
FusedPlan fused_mma_plan(const Geometry& g, int c, int kn) {
  for (int n = c <= 16 ? 16 : c <= 32 ? 32 : c <= 64 ? 64 : 128; n >= 16;
       n /= 2)
    for (int wmode = kWeightsPerLayer; wmode <= kWeightsPerChunk; ++wmode)
      for (int nwg = kFusedMaxWarpgroups; nwg >= 1; nwg /= 2) {
        const size_t smem =
            fused_mma_smem(c, kn, n, nwg, wmode, g.n_rows, g.n_cols);
        if (smem <= (size_t)hg::kMmaMaxSmem) return {n, nwg, wmode, smem};
      }
  return {0, 0, 0, 0};
}

// Input rows row0 .. row0 + band_rows - 1, columns col0 .. col0 + n_cols - 1,
// channels ci0 .. ci0 + 15 of the NHWC sample xb into xs, [row][group]
// [column] in 16-byte units, zero outside the image and past C (the units
// of hex_common.cuh::stage_patch, for a block of any size).  vec: 16-byte
// cp.async copies; otherwise element by element through the L2 (the
// scratch buffers are rewritten between layers by other blocks).
__device__ __forceinline__ void stage_band(
    uint4* xs, const __nv_bfloat16* xb, int H, int W, int C, int row0,
    int band_rows, int col0, int n_cols, int ci0, bool vec) {
  const int n_units = band_rows * 2 * n_cols;
  for (int e = threadIdx.x; e < n_units; e += blockDim.x) {
    const int grp = e & 1;
    const int c = (e >> 1) % n_cols;
    const int r = (e >> 1) / n_cols;
    const int gi = row0 + r, gj = col0 + c, gc = ci0 + 8 * grp;
    const bool inside = gi >= 0 && gi < H && gj >= 0 && gj < W;
    const long long pix = (long long)gi * W + gj;
    uint4* dst = xs + (r * 2 + grp) * n_cols + c;
    if (vec) {
      const bool live = inside && gc < C;
      hg::cp_async16(dst, live ? xb + pix * C + gc : xb, live ? 16 : 0);
    } else {
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = inside && gc + j < C
                   ? __ushort_as_bfloat16(__ldcg(
                         reinterpret_cast<const unsigned short*>(xb) +
                         pix * C + gc + j))
                   : __float2bfloat16(0.f);
      *dst = *reinterpret_cast<const uint4*>(v);
    }
  }
}

__device__ __forceinline__ float epilogue(float v, bool has_bias,
                                          const float* bias, int co,
                                          bool relu) {
  if (has_bias) v += bias[co];
  if (relu) v = fmaxf(v, 0.f);
  return v;
}

// x, out: (B, H, W, C); buf0, buf1: (group, H, W, C) scratch; w: the
// packed weights (L, chunks, kn, 2, C, 8); bias: (L, C) float32.
template <int N>
__global__ void __launch_bounds__(kFusedMaxWarpgroups * kConvThreads)
fused_stack_mma_kernel(const __nv_bfloat16* __restrict__ x,
                       __nv_bfloat16* out, __nv_bfloat16* buf0,
                       __nv_bfloat16* buf1,
                       const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ bias,
                       unsigned long long bias_bits,
                       unsigned long long relu_bits, int L, int B, int group,
                       int H, int W, int C, int kn,
                       const __grid_constant__ hg::TapTable taps, int r_lo,
                       int n_rows, int c_lo, int n_cols, int wmode, int vec) {
  constexpr int RW = fused_rw(N);
  extern __shared__ __align__(16) uint4 fsmem[];
  cg::grid_group grid = cg::this_grid();
  const int wg = threadIdx.x / kConvThreads;
  const int warp = (threadIdx.x % kConvThreads) / 32;
  const int lane = threadIdx.x % 32;
  const int R = (blockDim.x / kConvThreads) * RW;     // rows of a band
  const int band_rows = R + n_rows - 1;
  const int n_chunks = (C + kChunkC - 1) / kChunkC;
  const int n_cob = (C + N - 1) / N;
  const int npad = n_cob * N;
  const int n_bands = (H + R - 1) / R;
  const int n_strips = (W + kTileP - 1) / kTileP;
  const int band_units = band_rows * 2 * n_cols;
  const int stage_units =
      band_units + (wmode == kWeightsPerChunk ? kn * 2 * N : 0);
  const int layer_units = n_chunks * kn * 2 * npad;
  uint4* slab = fsmem + 2 * stage_units;   // per-layer weights
  const uint4* wu = reinterpret_cast<const uint4*>(w);
  const long long plane = (long long)H * W * C;
  const bool pairs = C % 2 == 0;

  // layer l's slab into slab, [chunk][tap][group][npad], zero past C
  auto stage_layer = [&](int l) {
    const uint4* src = wu + (long long)l * n_chunks * kn * 2 * C;
    for (int e = threadIdx.x; e < layer_units; e += blockDim.x) {
      const int co = e % npad;
      const long long row = e / npad;
      hg::cp_async16(slab + e, co < C ? src + row * C + co : src,
                     co < C ? 16 : 0);
    }
  };

  float acc[RW][N / 2];
  for (int g0 = 0; g0 < B; g0 += group) {
    const int gb = B - g0 < group ? B - g0 : group;
    const long long tiles = (long long)gb * n_bands * n_strips * n_cob;
    const long long my_tiles =
        blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
    const long long n_stages = my_tiles * n_chunks;
    for (int l = 0; l < L; ++l) {
      // layer l - 1 wrote buf0 when l - 1 is even
      const __nv_bfloat16* src =
          l == 0 ? x + g0 * plane : (l % 2 ? buf0 : buf1);
      __nv_bfloat16* dst =
          l == L - 1 ? out + g0 * plane : (l % 2 ? buf1 : buf0);
      const bool has_bias = (bias_bits >> l) & 1ull;
      const bool relu = (relu_bits >> l) & 1ull;
      const float* bl = bias + (long long)l * C;
      if (wmode == kWeightsPerLayer) {
        stage_layer(l);
        hg::cp_async_commit();
      }

      // stage s is chunk s % n_chunks of this block's tile s / n_chunks;
      // a tile is (sample, band, strip, channel block), the last fastest
      auto tile_of = [&](long long s, long long& b, int& o0, int& w0,
                         int& co0) {
        long long t = blockIdx.x + (s / n_chunks) * gridDim.x;
        co0 = (int)(t % n_cob) * N;
        t /= n_cob;
        w0 = (int)(t % n_strips) * kTileP;
        t /= n_strips;
        o0 = (int)(t % n_bands) * R;
        b = t / n_bands;
      };
      auto stage = [&](long long s) {
        long long b;
        int o0, w0, co0;
        tile_of(s, b, o0, w0, co0);
        const int chunk = (int)(s % n_chunks);
        uint4* xs = fsmem + (s & 1) * stage_units;
        stage_band(xs, src + b * plane, H, W, C, o0 + r_lo, band_rows,
                   w0 + c_lo, n_cols, chunk * kChunkC, vec != 0);
        if (wmode == kWeightsPerChunk) {
          const uint4* wc =
              wu + (long long)(l * n_chunks + chunk) * kn * 2 * C;
          for (int e = threadIdx.x; e < kn * 2 * N; e += blockDim.x) {
            const int co = co0 + e % N;
            const int tg = e / N;             // tap * 2 + group
            hg::cp_async16(xs + band_units + e,
                           co < C ? wc + (long long)tg * C + co : wc,
                           co < C ? 16 : 0);
          }
        }
        hg::cp_async_commit();
      };

      if (n_stages > 0) stage(0);
      for (long long s = 0; s < n_stages; ++s) {
        if (s + 1 < n_stages) {
          stage(s + 1);
          hg::cp_async_wait<1>();
        } else {
          hg::cp_async_wait<0>();
        }
        // this thread's copies and stores, seen by the tensor cores' proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        long long b;
        int o0, w0, co0;
        tile_of(s, b, o0, w0, co0);
        const int chunk = (int)(s % n_chunks);
        const uint4* xs = fsmem + (s & 1) * stage_units;
        const uint4* wb;
        int wn;                     // units from one group to the next
        if (wmode == kWeightsPerChunk) {
          wb = xs + band_units;
          wn = N;
        } else {
          wb = slab + (long long)chunk * kn * 2 * npad + co0;
          wn = npad;
        }
#pragma unroll
        for (int j = 0; j < RW; ++j) {
          if (chunk == 0) {
#pragma unroll
            for (int i = 0; i < N / 2; ++i) acc[j][i] = 0.f;
          }
          hg::fence_acc(acc[j]);
        }
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int j = 0; j < RW; ++j) {
          const int i = wg * RW + j;          // the row in the band
          const int o = o0 + i;
          if (o >= H) continue;               // the same for the warpgroup
          const int q = o & 1;
          for (int t = 0; t < kn; ++t) {
            const uint4* a = xs + (i + taps.dr[q][t] - r_lo) * 2 * n_cols +
                             (taps.dc[q][t] - c_lo);
            hg::Wgmma<N>::mma(acc[j], hg::mma_desc(a, n_cols * 16, 128),
                              hg::mma_desc(wb + t * 2 * wn, wn * 16, 128));
          }
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
        for (int j = 0; j < RW; ++j) hg::fence_acc(acc[j]);
        if (chunk == n_chunks - 1) {
          // kernel B's epilogue: bias, ReLU, bf16
#pragma unroll
          for (int j = 0; j < RW; ++j) {
            const int o = o0 + wg * RW + j;
            if (o >= H) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int pix = w0 + 16 * warp + lane / 4 + 8 * h;
              if (pix >= W) continue;
              __nv_bfloat16* op =
                  dst + b * plane + ((long long)o * W + pix) * C;
#pragma unroll
              for (int i = 0; i < N / 8; ++i) {
                const int co = co0 + 8 * i + 2 * (lane % 4);
                if (co >= C) continue;
                const float v0 =
                    epilogue(acc[j][4 * i + 2 * h], has_bias, bl, co, relu);
                if (co + 1 >= C) {
                  store(op + co, v0);
                  continue;
                }
                const float v1 = epilogue(acc[j][4 * i + 2 * h + 1], has_bias,
                                          bl, co + 1, relu);
                if (pairs) {
                  *reinterpret_cast<__nv_bfloat162*>(op + co) =
                      __floats2bfloat162_rn(v0, v1);
                } else {
                  store(op + co, v0);
                  store(op + co + 1, v1);
                }
              }
            }
          }
        }
        __syncthreads();   // the buffer is free for the stage after next
      }
      // a block without a tile in this layer still owns its weight copies
      hg::cp_async_wait<0>();
      // the next layer (or the next group's first) reads what this one
      // wrote, or overwrites what it read
      if (l < L - 1 || g0 + group < B) grid.sync();
    }
  }
}

// ---- float32: the CUDA-core tile ---------------------------------------

// flags: hg::conv_tile's copy flags, and hg::kF32VecOut for 16-byte stores;
// kGroups: the tile's taps in groups of tg (hg::F32Plan)
template <int COB, bool kGroups>
__global__ void __launch_bounds__(kF32Threads, 2)
hex_conv_fused_stack_kernel(const float* __restrict__ x,
                            float* __restrict__ out, float* buf0, float* buf1,
                            const float* __restrict__ w,
                            const float* __restrict__ bias,
                            unsigned long long bias_bits,
                            unsigned long long relu_bits, int L, int B,
                            int group, int H, int W, int C, int kn, int tg,
                            const __grid_constant__ hg::TapTable taps,
                            int r_lo, int n_rows, int c_lo, int n_cols,
                            int flags) {
  using T = hg::F32Tile<COB>;
  constexpr int CT = T::kCT;
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int n_strips = (W + kTileP - 1) / kTileP;
  const int n_bands = (H + T::kRows - 1) / T::kRows;
  const int n_cob = (C + COB - 1) / COB;
  const long long plane = (long long)H * W * C;
  const long long layer_w = (long long)kn * C * C;
  const int cl = threadIdx.x % 8;
  const int tc = (threadIdx.x / 8) % T::kCL;
  const int row = (threadIdx.x / 8) / T::kCL;
  // one stage holds a layer's weights: COB = 16, one channel block
  const bool one_chunk = C <= kChunkC && !kGroups;
  const bool vec_out = (flags & hg::kF32VecOut) != 0;

  for (int g0 = 0; g0 < B; g0 += group) {
    const int gb = B - g0 < group ? B - g0 : group;
    const long long tiles = (long long)gb * n_bands * n_strips * n_cob;
    for (int l = 0; l < L; ++l) {
      // layer l - 1 wrote buf0 when l - 1 is even
      const float* src = l == 0 ? x + g0 * plane : (l % 2 ? buf0 : buf1);
      float* dst = l == L - 1 ? out + g0 * plane : (l % 2 ? buf1 : buf0);
      const float* wl = w + l * layer_w;
      const bool has_bias = (bias_bits >> l) & 1ull;
      const bool relu = (relu_bits >> l) & 1ull;
      bool staged = false;
      for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int strip = (int)(tile % n_strips);
        long long rest = tile / n_strips;
        const int co0 = (int)(rest % n_cob) * COB;
        rest /= n_cob;
        const int o0 = (int)(rest % n_bands) * T::kRows;
        const long long b = rest / n_bands;
        const int w0 = strip * kTileP;
        float acc[kF32Pix][CT];
        hg::conv_tile<COB, false, kGroups>(
                           src + b * plane, wl, smem, H, W, C, C, kn, tg,
                           taps, r_lo, n_rows, c_lo, n_cols, o0, w0, co0,
                           !(staged && one_chunk), flags, acc);
        staged = true;
        const int o = o0 + row;
        if (o >= H) continue;
#pragma unroll
        for (int i = 0; i < kF32Pix; ++i) {
          const int pix = w0 + cl + 8 * i;
          if (pix >= W) continue;
          float* op = dst + b * plane + ((long long)o * W + pix) * C;
#pragma unroll
          for (int h = 0; h < CT / 4; ++h) {
            const int co = co0 + h * (COB / 2) + 4 * tc;
            if (co >= C) continue;
            float v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              v[j] = acc[i][4 * h + j];
              if (has_bias && co + j < C) v[j] += bias[l * C + co + j];
              if (relu) v[j] = fmaxf(v[j], 0.f);
            }
            if (vec_out) {
              *reinterpret_cast<float4*>(op + co) =
                  make_float4(v[0], v[1], v[2], v[3]);
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (co + j < C) store(op + co + j, v[j]);
            }
          }
        }
      }
      // the next layer (or the next group's first) reads what this one
      // wrote, or overwrites what it read
      if (l < L - 1 || g0 + group < B) grid.sync();
    }
  }
}

// The cooperative launch of `kernel` with `threads` a block and `smem`
// bytes of dynamic shared memory over at most `tiles` blocks; plan[5] and
// plan[6] get the grid and the blocks resident on an SM.
template <typename K>
int launch_coop(K kernel, void** args, int threads, size_t smem,
                long long tiles, int* plan, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (!coop || per_sm < 1 || sms < 1) return -2;
  const long long resident = (long long)per_sm * sms;
  const int grid = (int)(tiles < resident ? tiles : resident);
  if (plan) {
    plan[5] = grid;
    plan[6] = per_sm;
  }
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(grid), dim3(threads), args, smem,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int COB>
int launch_f32(const void* x, void* out, void* buf0, void* buf1,
               const float* w, const float* bias, unsigned long long bias_bits,
               unsigned long long relu_bits, int L, int B, int group, int H,
               int W, int C, int kn, const Geometry& g, const hg::F32Plan& p,
               int* plan, cudaStream_t stream) {
  const long long tiles = (long long)group * ((H + p.rows - 1) / p.rows) *
                          ((W + kTileP - 1) / kTileP) * ((C + COB - 1) / COB);
  if (plan) {
    const int q[5] = {COB, p.rows, kF32Threads,
                      C <= kChunkC && p.taps == kn ? kWeightsPerLayer
                                                   : kWeightsPerChunk,
                      (int)p.smem};
    for (int i = 0; i < 5; ++i) plan[i] = q[i];
  }
  const bool vec = C % 4 == 0 && aligned16(x) && aligned16(buf0) &&
                   aligned16(buf1);
  int flags = (vec ? hg::kF32VecX : 0) |
              (C % 4 == 0 && aligned16(w) ? hg::kF32VecW : 0) |
              (vec && aligned16(out) ? hg::kF32VecOut : 0) |
              (p.stages == 2 ? hg::kF32TwoStages : 0);
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  float* b0 = static_cast<float*>(buf0);
  float* b1 = static_cast<float*>(buf1);
  hg::TapTable taps = g.taps;
  int tg = p.taps;
  int r_lo = g.r_lo, n_rows = p.band, c_lo = g.c_lo, n_cols = g.n_cols;
  void* args[] = {&xp, &op, &b0, &b1, &w, &bias, &bias_bits, &relu_bits,
                  &L, &B, &group, &H, &W, &C, &kn, &tg, &taps, &r_lo,
                  &n_rows, &c_lo, &n_cols, &flags};
  return launch_coop(p.taps < kn ? hex_conv_fused_stack_kernel<COB, true>
                                 : hex_conv_fused_stack_kernel<COB, false>,
                     args, kF32Threads, p.smem, tiles, plan, stream);
}

template <int N>
int launch_mma(const void* x, void* out, void* buf0, void* buf1,
               const void* w, const float* bias, unsigned long long bias_bits,
               unsigned long long relu_bits, int L, int B, int group, int H,
               int W, int C, int kn, const Geometry& g, const FusedPlan& p,
               int* plan, cudaStream_t stream) {
  const int rows = p.nwg * fused_rw(N);
  const long long tiles = (long long)group * ((H + rows - 1) / rows) *
                          ((W + kTileP - 1) / kTileP) * ((C + N - 1) / N);
  if (plan) {
    const int q[5] = {N, rows, p.nwg * kConvThreads, p.wmode, (int)p.smem};
    for (int i = 0; i < 5; ++i) plan[i] = q[i];
  }
  // 16-byte copies where every unit of 8 channels lies whole in one aligned
  // input (out is only written)
  int vec = C % 8 == 0 && aligned16(x) && aligned16(buf0) && aligned16(buf1);
  auto xp = static_cast<const __nv_bfloat16*>(x);
  auto op = static_cast<__nv_bfloat16*>(out);
  auto b0 = static_cast<__nv_bfloat16*>(buf0);
  auto b1 = static_cast<__nv_bfloat16*>(buf1);
  auto wp = static_cast<const __nv_bfloat16*>(w);
  hg::TapTable taps = g.taps;
  int r_lo = g.r_lo, n_rows = g.n_rows, c_lo = g.c_lo, n_cols = g.n_cols;
  int wmode = p.wmode;
  void* args[] = {&xp, &op, &b0, &b1, &wp, &bias, &bias_bits, &relu_bits,
                  &L, &B, &group, &H, &W, &C, &kn, &taps, &r_lo, &n_rows,
                  &c_lo, &n_cols, &wmode, &vec};
  return launch_coop(fused_stack_mma_kernel<N>, args, p.nwg * kConvThreads,
                     p.smem, tiles, plan, stream);
}

}  // namespace

// The stack.  x and out: (B, H, W, C) of `dtype` (0 = float32,
// 1 = bfloat16); buf0, buf1: (group, H, W, C) scratch of the same dtype.
// w: float32 (L, kn, C, C), layer l's (kn, Cin, Cout) block at
// l * kn * C * C; for bfloat16 the layers' weights rounded to bf16 and
// packed as conv_stack.py::_pack_mma_weights packs one layer, stacked:
// (L, ceil(C / 16), kn, 2, C, 8), 16-byte aligned.  bias: (L, C) float32,
// read for the layers whose bit is set in bias_bits (may be null when none
// is); relu_bits: ReLU after layer l when bit l is set; taps: host
// (2, kn, 2) int32.  plan: null, or 7 host ints that get the launch's
// output channels a tile (N, or the float32 tile's COB), band rows (the
// float32 tile's rows), threads
// a block, weights mode (0 per layer, 1 per chunk), dynamic
// shared memory bytes, grid and blocks resident on an SM.  Returns 0, the
// first CUDA error, -1 for arguments the kernel does not take (bfloat16:
// also where no tile fits in shared memory), or -2 when the device cannot
// run the cooperative launch.
extern "C" int hg_hex_conv_fused_stack(
    const void* x, void* out, void* buf0, void* buf1, const void* w,
    const void* bias, unsigned long long bias_bits,
    unsigned long long relu_bits, int dtype, int L, int B, int group, int H,
    int W, int C, int kn, const void* taps, int* plan, void* stream) {
  if (kn < 1 || kn > kMaxTaps || L < 2 || L > kMaxLayers || B < 1 ||
      group < 1 || H < 1 || W < 1 || C < 1 || !buf0 || !buf1 ||
      (bias_bits && !bias))
    return -1;
  const Geometry g = hg::make_geometry(static_cast<const int*>(taps), kn);
  auto s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0) {
    const float* wf = static_cast<const float*>(w);
    const hg::F32Plan p = hg::conv_tile_plan(g, kn, C, C);
    switch (p.cob) {
#define HG_FUSED_F32(N)                                                     \
  case N:                                                                   \
    return launch_f32<N>(x, out, buf0, buf1, wf, b, bias_bits, relu_bits,   \
                         L, B, group, H, W, C, kn, g, p, plan, s);
      HG_FUSED_F32(16)
      HG_FUSED_F32(32)
      HG_FUSED_F32(64)
#undef HG_FUSED_F32
      default:
        return -1;
    }
  }
  if (dtype != 1 || !aligned16(w)) return -1;
  const FusedPlan p = fused_mma_plan(g, C, kn);
  switch (p.n) {
#define HG_FUSED_N(N)                                                       \
  case N:                                                                   \
    return launch_mma<N>(x, out, buf0, buf1, w, b, bias_bits, relu_bits, L, \
                         B, group, H, W, C, kn, g, p, plan, s);
    HG_FUSED_N(16)
    HG_FUSED_N(32)
    HG_FUSED_N(64)
    HG_FUSED_N(128)
#undef HG_FUSED_N
    default:
      return -1;
  }
}
