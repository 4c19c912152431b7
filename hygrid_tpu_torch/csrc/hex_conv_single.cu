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
// dtype; sums are float32.  The bias is added by the caller after the
// kernel, in the output dtype, as conv_pallas.py:205-206 does.
//
// What bounds it: arithmetic.  HexCNN-small's five kernel layers at 512^2
// input and b=32 are 119 GFLOP on about 1 GB of f32 activations, well above
// the memory balance point, so each dtype runs on its fastest unit:
//
// bfloat16: the tensor cores, hex_common.cuh::conv_tile_mma_nchw, kernel
// B's implicit GEMM (64 pixels of one output row x N output channels x K =
// (16-channel chunk, tap), wgmma m64nNk16 on shifted windows of one patch)
// staged from NCHW by a transposing gather.  The weights are the packed
// bf16 tensor of conv_stack.py::_pack_mma_weights, so with the same K order
// and the valid tap table (the 'same' one shifted by the padding) the
// output on a padded input is bit-equal to hex_conv_layer.cu's 'same' conv.
//
// float32: the CUDA cores, in conv_tile's order (chunks of 16 input
// channels, then taps, then the chunk's channels), so it stays bit-equal to
// hex_conv_layer.cu's float32 conv.  It differs from that tile in what
// fills a block:
//   * Short rows are packed.  Where Wo < 64, one block's 64 pixels are S =
//     64 / Wo whole output rows of one parity (rows of samples one after
//     another, so a block may span samples), each pixel reading its own
//     row's patch: BN-CIFAR's rows of 16, 7 and 3 pixels fill 64, 63 and
//     63 of a block's 64 lanes (one row a block would leave 75-95 % idle).
//     The patch of each packed row is staged side by side in shared
//     memory, so pixel p of row s reads column p + s * (tap width).
//   * A wider register tile.  Above 32 output channels a block covers 64
//     of them and each thread 4 pixels x 8 channels, so each staged input
//     value feeds 8 FMAs, not 4.
//   * Cheap staging.  A chunk's patch (4-byte cp.async, zero fill) and
//     weights (16-byte cp.async where Cout % 4 == 0) are copied in one
//     stage: at 41 KB a block (64 channels, radius 2) four blocks share an
//     SM and hide each other's copies (two stages of 83 KB would leave two,
//     1.2x slower at BN-512 on an H100 80GB HBM3 at 700 W).  Each
//     thread's global offsets come from a per-block table, so the staging
//     loop does no division.
#include <climits>

#include "hex_common.cuh"

namespace {

using hg::kChunkC;
using hg::kConvThreads;
using hg::kMaxTaps;
using hg::kTileP;
using hg::Geometry;
using hg::store;

// ---- float32: the packed CUDA-core tile ------------------------------------

// COB output channels a block, PT pixels x CT channels a thread.
template <int COB>
struct F32Tile {
  static constexpr int kCT = COB > 32 ? 8 : 4;
  static constexpr int kPT = kTileP * COB / (kCT * kConvThreads);
  static constexpr int kPixLanes = kTileP / kPT;
  static_assert(kPT * kPixLanes == kTileP &&
                kPixLanes * (COB / kCT) == kConvThreads, "tile shape");
};

// How the float32 tiles cover the output, chosen on the host
// (conv_single.py::_f32_plan mirrors it).
struct Packing {
  int cob;      // output channels a block: 16, 32 or 64
  int S;        // output rows a block (1: one row's 64-pixel tile)
  int sw;       // pixels of each of them: Wo when S > 1, else 64
  int ncs;      // staged columns of each: sw + tap width
  int nv;       // staged columns in all: S * ncs
  int tiles0;   // tiles of even output rows (the odd ones follow)
  int tiles;    // tiles in all
};

constexpr size_t kMaxSmem = 232448;   // shared memory a block may use (H100)

size_t f32_smem(int cob, int n_rows, int kn, int nv) {
  return sizeof(float) * ((size_t)n_rows * kChunkC * nv +
                          (size_t)kn * kChunkC * cob) +
         (sizeof(long long) + sizeof(int)) * (size_t)nv;
}

// Output rows of parity q in one sample.
__host__ __device__ inline int rows_of_parity(int Ho, int q) {
  return (Ho + 1 - q) / 2;
}

// The largest tile that fits: COB from Cout, S = 64 / Wo rows where Wo <
// 64; where shared memory is short, half the channels, else half the rows.
// cob 0: nothing fits.
Packing f32_packing(const Geometry& g, int kn, int B, int Cin, int Ho,
                    int Wo, int Cout) {
  Packing p{};
  p.cob = Cout <= 16 ? 16 : Cout <= 32 ? 32 : 64;
  p.S = Wo < kTileP ? kTileP / Wo : 1;
  const int tap_width = g.n_cols - kTileP;
  for (;;) {
    p.sw = p.S > 1 ? Wo : kTileP;
    p.ncs = p.sw + tap_width;
    p.nv = p.S * p.ncs;
    if (f32_smem(p.cob, g.n_rows, kn, p.nv) <= kMaxSmem) break;
    if (p.cob > 16) {
      p.cob /= 2;
    } else if (p.S > 1) {
      p.S /= 2;
    } else {
      p.cob = 0;
      return p;
    }
  }
  const int per_row = p.S > 1 ? 1 : (Wo + kTileP - 1) / kTileP;
  for (int q = 0; q < 2; ++q) {
    const long long rows = (long long)B * rows_of_parity(Ho, q);
    const long long tiles =
        p.S > 1 ? (rows + p.S - 1) / p.S : rows * per_row;
    if (tiles > INT_MAX / 2) {
      p.cob = 0;
      return p;
    }
    if (q == 0) p.tiles0 = (int)tiles;
    p.tiles += (int)tiles;
  }
  return p;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

// A block: tile blockIdx.x (even rows' tiles first), output channels
// blockIdx.y * COB ...  Shared memory: [n_rows][16][nv] patch floats,
// [kn][16][COB] weight floats, then the staging table.
template <int COB>
__global__ void __launch_bounds__(kConvThreads)
hex_conv_single_fma_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           float* __restrict__ out, int B, int H, int W,
                           int Cin, int Ho, int Wo, int Cout, int kn,
                           const __grid_constant__ hg::TapTable taps,
                           int r_lo, int n_rows, int c_lo,
                           const Packing pk, int vec_w) {
  using Tile = F32Tile<COB>;
  constexpr int PT = Tile::kPT, CT = Tile::kCT;
  constexpr int kPixLanes = Tile::kPixLanes;
  extern __shared__ __align__(16) float smem[];
  const int nv = pk.nv;
  float* xs = smem;                               // [n_rows][16][nv]
  float* ws = xs + n_rows * kChunkC * nv;         // [kn][16][COB]
  auto* src_off = reinterpret_cast<long long*>(ws + kn * kChunkC * COB);
  auto* src_row = reinterpret_cast<int*>(src_off + nv);

  const int q = blockIdx.x < (unsigned)pk.tiles0 ? 0 : 1;
  const int tile = blockIdx.x - (q ? pk.tiles0 : 0);
  const int nq = rows_of_parity(Ho, q);
  const long long rows = (long long)B * nq;
  long long first;        // the block's first row among rows of parity q
  int n_seg, w0;
  if (pk.S > 1) {
    first = (long long)tile * pk.S;
    n_seg = (int)min((long long)pk.S, rows - first);
    w0 = 0;
  } else {
    const int per_row = (Wo + kTileP - 1) / kTileP;
    first = tile / per_row;
    n_seg = 1;
    w0 = (tile % per_row) * kTileP;
  }
  const int co0 = blockIdx.y * COB;
  const int tid = threadIdx.x;
  const long long plane = (long long)H * W;

  // staged column v: packed row v / ncs, patch column v % ncs; its offset
  // in the sample-major input at channel 0, patch row 0, and that row
  for (int v = tid; v < nv; v += kConvThreads) {
    const int s = v / pk.ncs, c = v % pk.ncs;
    int gi0 = INT_MIN / 2;        // fails every row check
    long long off = 0;
    if (s < n_seg) {
      const long long row = first + s;
      const long long b = row / nq;
      const int o = q + 2 * (int)(row % nq);
      const int gj = w0 + c_lo + c;
      if (gj >= 0 && gj < W) {
        gi0 = o + r_lo;
        off = b * Cin * plane + (long long)gi0 * W + gj;
      }
    }
    src_off[v] = off;
    src_row[v] = gi0;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  auto stage = [&](int chunk) {
    const int ci0 = chunk * kChunkC;
    for (int rk = warp; rk < n_rows * kChunkC; rk += kConvThreads / 32) {
      const int r = rk / kChunkC, gc = ci0 + rk % kChunkC;
      for (int v = lane; v < nv; v += 32) {
        const int gi = src_row[v] + r;
        const bool ok = gc < Cin && gi >= 0 && gi < H;
        cp_async4(xs + rk * nv + v,
                  ok ? x + src_off[v] + (gc * plane + (long long)r * W) : x,
                  ok ? 4 : 0);
      }
    }
    if (vec_w) {
      constexpr int kUnits = COB / 4;
      for (int e = tid; e < kn * kChunkC * kUnits; e += kConvThreads) {
        const int u = e % kUnits, row = e / kUnits;   // row: tap * 16 + ck
        const int gc = ci0 + row % kChunkC, co = co0 + 4 * u;
        const bool ok = gc < Cin && co < Cout;
        hg::cp_async16(ws + row * COB + 4 * u,
                       ok ? w + ((long long)(row / kChunkC) * Cin + gc) * Cout
                                + co
                          : w,
                       ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kn * kChunkC * COB; e += kConvThreads) {
        const int co = co0 + e % COB, row = e / COB;
        const int gc = ci0 + row % kChunkC;
        const bool ok = gc < Cin && co < Cout;
        cp_async4(ws + e,
                  ok ? w + ((long long)(row / kChunkC) * Cin + gc) * Cout + co
                     : w,
                  ok ? 4 : 0);
      }
    }
    hg::cp_async_commit();
  };

  // pixel p = tp + i * kPixLanes of the tile is pixel p % sw of packed row
  // p / sw, and reads staged column p + (p / sw) * tap width (+ the tap's)
  const int tp = tid % kPixLanes, tc = tid / kPixLanes;
  const int tap_width = pk.ncs - pk.sw;
  int xoff[PT];
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int p = tp + i * kPixLanes;
    const int s = p / pk.sw;
    xoff[i] = s < n_seg ? p + s * tap_width : 0;
  }
  float acc[PT][CT];
#pragma unroll
  for (int i = 0; i < PT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;

  const int n_chunks = (Cin + kChunkC - 1) / kChunkC;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    stage(chunk);
    hg::cp_async_wait<0>();
    __syncthreads();
    for (int t = 0; t < kn; ++t) {
      const float* xr = xs + (taps.dr[q][t] - r_lo) * kChunkC * nv +
                        (taps.dc[q][t] - c_lo);
      const float* wr = ws + t * kChunkC * COB + tc * CT;
#pragma unroll
      for (int ck = 0; ck < kChunkC; ++ck) {
        float wv[CT];
#pragma unroll
        for (int j = 0; j < CT; j += 4) {
          const float4 f = *reinterpret_cast<const float4*>(wr + ck * COB + j);
          wv[j] = f.x;
          wv[j + 1] = f.y;
          wv[j + 2] = f.z;
          wv[j + 3] = f.w;
        }
#pragma unroll
        for (int i = 0; i < PT; ++i) {
          const float xv = xr[ck * nv + xoff[i]];
#pragma unroll
          for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();   // the buffers are free for the next chunk
  }

  const long long oplane = (long long)Ho * Wo;
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int p = tp + i * kPixLanes;
    const int s = p / pk.sw, pix = w0 + p % pk.sw;
    if (s >= n_seg || pix >= Wo) continue;
    const long long row = first + s;
    const long long b = row / nq;
    const int o = q + 2 * (int)(row % nq);
    float* op = out + b * Cout * oplane + (long long)o * Wo + pix;
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int co = co0 + tc * CT + j;
      if (co < Cout) op[co * oplane] = acc[i][j];
    }
  }
}

template <int COB>
int launch_f32(const float* x, const float* w, float* out, int B, int H,
               int W, int Cin, int Ho, int Wo, int Cout, int kn,
               const Geometry& g, const Packing& pk, cudaStream_t stream) {
  const size_t smem = f32_smem(COB, g.n_rows, kn, pk.nv);
  auto kernel = hex_conv_single_fma_kernel<COB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec_w = Cout % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
  dim3 grid(pk.tiles, (Cout + COB - 1) / COB);
  kernel<<<grid, kConvThreads, smem, stream>>>(
      x, w, out, B, H, W, Cin, Ho, Wo, Cout, kn, g.taps, g.r_lo, g.n_rows,
      g.c_lo, pk, vec_w);
  return (int)cudaGetLastError();
}

// ---- bfloat16: the tensor-core tile on NCHW --------------------------------

// One block: output row blockIdx.y, pixels blockIdx.x * 64 .., sample and
// channel tile blockIdx.z.  w: the packed bf16 weights.
template <int N>
__global__ void __launch_bounds__(kConvThreads)
hex_conv_single_mma_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ w,
                           __nv_bfloat16* __restrict__ out, int H, int W,
                           int Cin, int Ho, int Wo, int Cout, int kn,
                           const __grid_constant__ hg::TapTable taps,
                           int r_lo, int n_rows, int c_lo, int n_cols) {
  extern __shared__ __align__(16) float smem[];
  const int n_cob = (Cout + N - 1) / N;
  const int b = blockIdx.z / n_cob;
  const int co0 = (blockIdx.z % n_cob) * N;
  const int o = blockIdx.y;
  const int w0 = blockIdx.x * kTileP;
  float acc[N / 2];
  hg::conv_tile_mma_nchw<N>(x + (long long)b * Cin * H * W, w,
                            reinterpret_cast<uint4*>(smem), H, W, Cin, Cout,
                            kn, taps, r_lo, n_rows, c_lo, n_cols, o, w0, co0,
                            acc);
  // acc[4 i + 2 h + j]: pixel w0 + 16 warp + lane / 4 + 8 h, channel
  // co0 + 8 i + 2 (lane % 4) + j (hex_common.cuh::conv_tile_mma)
  const int lane = threadIdx.x % 32;
  const long long oplane = (long long)Ho * Wo;
  __nv_bfloat16* ob = out + (long long)b * Cout * oplane + (long long)o * Wo;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pix = w0 + 16 * (threadIdx.x / 32) + lane / 4 + 8 * h;
    if (pix >= Wo) continue;
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int co = co0 + 8 * i + 2 * (lane % 4) + j;
        if (co < Cout) store(ob + co * oplane + pix, acc[4 * i + 2 * h + j]);
      }
  }
}

template <int N>
int launch_mma_n(const void* x, const void* w, void* out, int B, int H,
                 int W, int Cin, int Ho, int Wo, int Cout, int kn,
                 const Geometry& g, cudaStream_t stream) {
  const size_t smem = hg::conv_tile_mma_smem(g, kn, N, Cin);
  auto kernel = hex_conv_single_mma_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Wo + kTileP - 1) / kTileP, Ho, B * ((Cout + N - 1) / N));
  kernel<<<grid, kConvThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), H, W, Cin, Ho, Wo, Cout, kn, g.taps,
      g.r_lo, g.n_rows, g.c_lo, g.n_cols);
  return (int)cudaGetLastError();
}

}  // namespace

// One valid conv.  x: (B, Cin, H, W) and out: (B, Cout, Ho, Wo), both of
// `dtype` (0 = float32, 1 = bfloat16), contiguous; w: for float32 the
// (kn, Cin, Cout) float32 weights, for bfloat16 the same weights rounded to
// bf16 and packed as (ceil(Cin / 16), kn, 2, Cout, 8) (hex_conv_layer.cu's
// layout, conv_stack.py::_pack_mma_weights), 16-byte aligned; taps: host
// (2, kn, 2) int32 (hex_valid_tap_table).  The grid: float32, the tiles of
// _f32_plan x ceil(Cout / cob); bfloat16, ceil(Wo / 64) x Ho x B *
// ceil(Cout / N), N = hg::conv_tile_mma_n's (conv_single.py::_grid mirrors
// both).  Returns 0, the first CUDA error, or -1 for arguments the kernel
// does not take.
extern "C" int hg_hex_conv_single(const void* x, const void* w, void* out,
                                  int dtype, int B, int H, int W, int Cin,
                                  int Ho, int Wo, int Cout, int kn,
                                  const void* taps, void* stream) {
  if (kn < 1 || kn > kMaxTaps || B < 1 || H < 1 || W < 1 || Cin < 1 ||
      Ho < 1 || Wo < 1 || Cout < 1)
    return -1;
  const Geometry g = hg::make_geometry(static_cast<const int*>(taps), kn);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Packing pk = f32_packing(g, kn, B, Cin, Ho, Wo, Cout);
    if (pk.cob == 0 || (Cout + pk.cob - 1) / pk.cob > 65535) return -1;
    auto xf = static_cast<const float*>(x);
    auto wf = static_cast<const float*>(w);
    auto of = static_cast<float*>(out);
    switch (pk.cob) {
      case 16:
        return launch_f32<16>(xf, wf, of, B, H, W, Cin, Ho, Wo, Cout, kn, g,
                              pk, s);
      case 32:
        return launch_f32<32>(xf, wf, of, B, H, W, Cin, Ho, Wo, Cout, kn, g,
                              pk, s);
      default:
        return launch_f32<64>(xf, wf, of, B, H, W, Cin, Ho, Wo, Cout, kn, g,
                              pk, s);
    }
  }
  if (dtype != 1 || reinterpret_cast<uintptr_t>(w) % 16 != 0) return -1;
  const int n = hg::conv_tile_mma_n(g, kn, Cin, Cout);
  if (Ho > 65535 || (long long)B * ((Cout + n - 1) / n) > 65535) return -1;
  switch (n) {
#define HG_SINGLE_N(N)                                                      \
  case N:                                                                   \
    return launch_mma_n<N>(x, w, out, B, H, W, Cin, Ho, Wo, Cout, kn, g, s);
    HG_SINGLE_N(16)
    HG_SINGLE_N(32)
    HG_SINGLE_N(64)
    HG_SINGLE_N(128)
#undef HG_SINGLE_N
    default:
      return -1;
  }
}
