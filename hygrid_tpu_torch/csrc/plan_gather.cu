// plan_gather: execute a resampling plan (gather + blend) on B*C planes.
//
// Replaces: hygrid_tpu/kernels/resample_pallas.py::_resample_kernel (with
// _tile_body), launched by _apply_plan_pallas_impl, and the function of its
// banded, phased and phased-banded variants (_resample_kernel_banded,
// _resample_kernel_phased, _resample_kernel_phased_banded), which exist to
// fit the TPU's VMEM and MXU.
//
//   out[n, p] = sum_k w[k, p] * src[n, idx[k, p]]      (f32 accumulation)
//
// n runs over the planes, p over the h1*w1 output pixels; the taps are an
// fmaf chain in the plan's k order, rounded once to the image dtype.  The
// TPU builds one-hot selection matrices for the MXU; on Hopper the gather
// is an indexed load from shared memory.
//
// What bounds it: memory.  At the HexCNN-512 leg (rect->hex 512^2->256^2,
// bilinear K=4, 96 planes) it does 4 FMAs per output value and must move
// one plane of source and a quarter plane of output per plane.  The design
// moves little else:
// * a block owns a tile of 8 output rows (one warp each) by 32 x V columns
//   (V = 16 bytes of outputs a lane: 8 bf16, 4 f32) and walks a group of
//   planes; it reads its slice of the plan's tables into registers once,
//   not once per plane (launch() sizes the group from the kernel's
//   occupancy so that the grid is one wave of resident blocks);
// * for a row-band plan (every tap on source row rowbase[r] or
//   rowbase[r] + 1, kernels/resample.py::gather_tables) each plane's
//   source band (the tile's rows and columns, 16-byte aligned) is staged
//   in shared memory by 16-byte cp.async copies into a ring of kStages
//   buffers: the next three planes' bands load while one is blended, and
//   the first ones while the block reads its tables.  Neighbouring tiles
//   overlap by a row and a few columns; otherwise each source byte leaves
//   HBM once.  Other plans ("dense") gather from global memory;
// * lane l of a warp blends outputs l, l + 32, ... of the warp's segment,
//   so one warp-wide load reads 32 neighbouring taps (no bank conflicts at
//   any scale), then the warp transposes its outputs through shared memory
//   and each lane writes V adjacent outputs with one 16-byte store (a
//   masked scalar tail where the row is ragged or unaligned);
// * the tables are small: "parity" indices (the columns by row parity) and
//   "factored" weights (float64 row and column factors, the weight rebuilt
//   as float32((col * row) * valid) with unfused float64 products, as
//   ops/sampling.py::rect_sample_plan computes it) reproduce the rect->hex
//   plans bit for bit in a few KB, and a tile's slice of them arrives by
//   TMA with its first band; "rows" indices are 2 bytes a tap; weights
//   otherwise float32 a tap, read by each thread.
#include <atomic>
#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hex_common.cuh"

namespace {

constexpr int kWarps = 8;                 // output rows of a tile
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTaps = 8;
constexpr int kSmemMax = 227 * 1024;
constexpr int kStages = 4;                // source bands in flight, a ring
constexpr int kMaxDevices = 64;

// The last launch's grid (plane groups, column tiles, row tiles, shared
// memory bytes, resident blocks an SM), read by hg_plan_gather_last_launch
// for diagnostics; the launch itself returns nothing but its status.
std::atomic<int> g_last_launch[5];

enum IndexForm { kDense = 0, kRows = 1, kParity = 2 };
enum WeightForm { kPixel = 0, kFactored = 1 };

struct Plan {
  const void* idx;          // dense int32 (K, P); rows uint16 (K, P) holding
                            // col << 1 | d; parity int16 (K, 2, w1p)
  const uint8_t* dk;        // parity: row part d (K, h1)
  const float* wts;         // pixel weights (K, P)
  const double* rowf;       // factored (h1, 4): row factor a, validity a
  const double* colf;       // factored (2, 4, w1p): by row parity, column
                            // factor b, validity b
  const int* rowbase;       // (h1,)
  const int* tile_row_lo;   // (n_rtiles,) first band row of each row tile
  const int* tile_col_lo;   // (n_rtiles, n_ctiles) first band column
  long long n_planes;
  int h, w, h1, w1, w1p, k, band_rows, band_pitch, planes_per_block;
  bool vec_src, vec_out;    // 16-byte aligned source rows / output rows
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// One TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Shared memory of a block beyond its bands and the warps' output staging:
// the tile's table slice ("parity": its column offsets; "factored": its
// column factors too), then the table's mbarrier.
template <typename T, int K, int IF, int WF>
__host__ __device__ constexpr int table_smem() {
  return (IF == kParity ? K * 2 * 32 * 16 / (int)sizeof(T) * 2 : 0) +
         (WF == kFactored ? 2 * 4 * 32 * 16 / (int)sizeof(T) * 8 : 0);
}

// Stage rows [row_lo, row_lo + band_rows) x columns [col_lo, col_lo +
// band_pitch) of one source plane into `band` (row pitch band_pitch) with
// 16-byte cp.async copies from every thread, or element by element where
// the source rows are not 16-byte aligned.  Rows and columns outside the
// source are left as they are: no tap reads them.
template <typename T>
__device__ __forceinline__ void load_band(const T* __restrict__ plane,
                                          T* band, int row_lo, int col_lo,
                                          const Plan& p) {
  constexpr int CH = 16 / (int)sizeof(T);
  const int rows = min(p.band_rows, p.h - row_lo);
  const int cols = min(p.band_pitch, p.w - col_lo);
  if (p.vec_src) {
    const int cpr = cols / CH;
    for (int i = threadIdx.x; i < rows * cpr; i += kThreads) {
      const int br = i / cpr, bc = (i - br * cpr) * CH;
      hg::cp_async16(band + br * p.band_pitch + bc,
                     plane + (long long)(row_lo + br) * p.w + col_lo + bc, 16);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int br = i / cols, bc = i - br * cols;
      band[br * p.band_pitch + bc] =
          plane[(long long)(row_lo + br) * p.w + col_lo + bc];
    }
  }
}

// Thread 0 starts the TMA bulk copies of the tile's "parity" table slice
// (its column offsets, and with factored weights its column factors),
// completing on `bar`.
template <typename T, int WF>
__device__ __forceinline__ void load_table(short* tab_idx, double* tab_col,
                                           uint64_t* bar, int ct,
                                           const Plan& p) {
  constexpr int SEG = 32 * 16 / (int)sizeof(T);
  mbar_expect(bar, p.k * 2 * SEG * 2 + (WF == kFactored ? 8 * SEG * 8 : 0));
  for (int kp = 0; kp < p.k * 2; ++kp)               // (k, parity)
    bulk_copy(tab_idx + kp * SEG,
              static_cast<const short*>(p.idx) + (long long)kp * p.w1p +
                  ct * SEG,
              SEG * 2, bar);
  if (WF == kFactored)
    for (int qj = 0; qj < 8; ++qj)                   // (parity, j)
      bulk_copy(tab_col + qj * SEG, p.colf + (long long)qj * p.w1p + ct * SEG,
                SEG * 8, bar);
}

// Three blocks an SM for banded plans of up to 3 taps with weights a pixel
// (their tables leave the registers for it), two for the factored
// weights' float64 rebuild and for more taps (three would spill).
template <typename T, int K, int IF, int WF>
__global__ void __launch_bounds__(kThreads,
                                  WF == kPixel && IF != kDense && K <= 3 ? 3 : 2)
plan_gather_kernel(const T* __restrict__ src, T* __restrict__ out,
                   const Plan p) {
  constexpr int V = 16 / sizeof(T);
  constexpr int SEG = 32 * V;
  constexpr bool kBanded = IF != kDense;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ct = blockIdx.y, rt = blockIdx.z;
  const int r = rt * kWarps + warp;
  const int seg = ct * SEG;
  const bool row_live = r < p.h1;
  const long long P = (long long)p.h1 * p.w1;
  const int band_elems = p.band_rows * p.band_pitch;
  T* band = reinterpret_cast<T*>(smem);
  T* stage_all = band + kStages * band_elems;
  T* stage = stage_all + warp * SEG;
  short* tab_idx = reinterpret_cast<short*>(stage_all + kWarps * SEG);
  double* tab_col = reinterpret_cast<double*>(
      tab_idx + (IF == kParity ? K * 2 * SEG : 0));
  int row_lo = 0, col_lo = 0;
  if (kBanded) {
    row_lo = p.tile_row_lo[rt];
    col_lo = p.tile_col_lo[rt * gridDim.y + ct];
  }
  const int taps = K < kMaxTaps ? K : p.k;
  const long long plane = (long long)p.h * p.w;
  const long long n0 = (long long)blockIdx.x * p.planes_per_block;
  const long long n1 = min(n0 + p.planes_per_block, p.n_planes);
  // the parity table slice and the first kStages - 1 planes' bands start
  // loading before the tables are read
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(tab_idx) +
      table_smem<T, K, IF, WF>());
  if (IF == kParity) {
    if (threadIdx.x == 0) {
      mbar_init(bar);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      load_table<T, WF>(tab_idx, tab_col, bar, ct, p);
    }
  }
  if (kBanded) {
    for (int s = 0; s < kStages - 1; ++s) {
      if (n0 + s < n1)
        load_band(src + (n0 + s) * plane, band + s * band_elems, row_lo,
                  col_lo, p);
      hg::cp_async_commit();   // one group a stage, empty where unused
    }
  }
  if (IF == kParity) {
    __syncthreads();           // the barrier is initialised
    mbar_wait(bar, 0);
  }

  // the tile's slice of the tables, once per block: per output v of this
  // lane the K taps' offsets (into the band, or the plane for "dense") and
  // weights.  A warp is one output row: row entries are warp-uniform, and
  // lanes read neighbouring columns.
  int off[K][V];
  float wt[K][V];
  double rf[4] = {0., 0., 0., 0.};   // factored: row factor a, validity a
  if (WF == kFactored && row_live) {
#pragma unroll
    for (int j = 0; j < 4; ++j) rf[j] = __ldg(p.rowf + (long long)r * 4 + j);
  }
  int rb = 0;
  if (kBanded && row_live) rb = (p.rowbase[r] - row_lo) * p.band_pitch;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int cl = lane + 32 * v;    // column within the tile
    const int c = seg + cl;
    const bool live = row_live && c < p.w1;
    const long long pix = (long long)r * p.w1 + c;
    double cf[4] = {0., 0., 0., 0.};  // column factor b, validity b
    if (WF == kFactored && live) {
#pragma unroll
      for (int j = 0; j < 4; ++j) cf[j] = tab_col[((r & 1) * 4 + j) * SEG + cl];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      int o = 0;
      float wk = 0.f;
      if (live && k < taps) {
        if (IF == kDense) {
          o = __ldg(static_cast<const int*>(p.idx) + k * P + pix);
        } else if (IF == kRows) {
          const unsigned e =
              __ldg(static_cast<const unsigned short*>(p.idx) + k * P + pix);
          o = rb + (int)(e & 1u) * p.band_pitch + (int)(e >> 1);
        } else {
          const int d = __ldg(p.dk + (long long)k * p.h1 + r);
          o = rb + d * p.band_pitch + tab_idx[(k * 2 + (r & 1)) * SEG + cl];
        }
        if (WF == kPixel) {
          wk = __ldg(p.wts + k * P + pix);
        } else {  // tap k = 2a + b: (col_b * row_a) * (valid_a * valid_b)
          const int a = k >> 1, b = k & 1;
          wk = __double2float_rn(__dmul_rn(__dmul_rn(cf[b], rf[a]),
                                           __dmul_rn(rf[2 + a], cf[2 + b])));
        }
      }
      off[k][v] = o;
      wt[k][v] = wk;
    }
  }

  for (long long n = n0; n < n1; ++n) {
    const int slot = (int)((n - n0) % kStages);
    if (kBanded) {
      // plane n's band is in once at most kStages - 2 younger groups are
      // pending; after the barrier every warp has left plane n - 1's slot,
      // which takes plane n + kStages - 1
      hg::cp_async_wait<kStages - 2>();
      __syncthreads();
      const long long nn = n + kStages - 1;
      if (nn < n1)
        load_band(src + nn * plane,
                  band + (int)((nn - n0) % kStages) * band_elems, row_lo,
                  col_lo, p);
      hg::cp_async_commit();
    }
    if (row_live) {  // warp-uniform
      const T* b = kBanded ? band + slot * band_elems : src + n * plane;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (k < taps) acc = fmaf(wt[k][v], hg::to_f32(b[off[k][v]]), acc);
        hg::store(stage + lane + 32 * v, acc);
      }
      __syncwarp();
      T* o = out + n * P + (long long)r * p.w1;
      const int c = seg + lane * V;
      if (p.vec_out && c + V <= p.w1) {
        *reinterpret_cast<uint4*>(o + c) =
            *reinterpret_cast<const uint4*>(stage + lane * V);
      } else {
        for (int e = 0; e < V && c + e < p.w1; ++e) o[c + e] = stage[lane * V + e];
      }
      __syncwarp();
    }
  }
}

// The plane group a block walks: where the tiles leave room on the card,
// the planes are cut so that the grid is one wave of resident blocks (each
// block reads its tile's tables once and its prologue is paid once an SM);
// where there are more tiles than resident blocks, a block walks every
// plane.
template <typename T, int K, int IF, int WF>
int launch(const void* src, void* out, Plan p, int n_ct, int n_rt, int smem,
           cudaStream_t stream) {
  auto kernel = plan_gather_kernel<T, K, IF, WF>;
  if (IF != kDense) smem += table_smem<T, K, IF, WF>() + 8;
  if (smem > kSmemMax) return -1;
  // the shared-memory attribute and the occupancy are asked of the runtime
  // once per instantiation, device and size, not at every launch (the
  // queries cost more host time than a small launch's kernel takes)
  struct Seen { int smem, per_sm, sms; };
  static std::mutex lock;
  static Seen seen[kMaxDevices] = {};
  static int smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return -1;
  Seen s;
  {
    std::lock_guard<std::mutex> guard(lock);
    s = seen[dev];
  }
  if (s.smem != smem || s.per_sm < 1) {
    std::lock_guard<std::mutex> guard(lock);
    if (smem > 48 * 1024 && smem > smem_set[dev]) {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      smem_set[dev] = smem;
    }
    s = Seen{smem, 0, 0};
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.per_sm, kernel,
                                                      kThreads, smem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (s.per_sm < 1) return -1;
    seen[dev] = s;
  }
  const int per_sm = s.per_sm, sms = s.sms;
  const long long tiles = (long long)n_ct * n_rt;
  long long groups = (long long)per_sm * sms / tiles;
  groups = groups < 1 ? 1 : (groups > p.n_planes ? p.n_planes : groups);
  const long long ppb = (p.n_planes + groups - 1) / groups;
  groups = (p.n_planes + ppb - 1) / ppb;
  if (ppb > 2147483647LL || groups > 2147483647LL) return -1;
  p.planes_per_block = (int)ppb;
  const int grid_info[5] = {(int)groups, n_ct, n_rt, smem, per_sm};
  for (int i = 0; i < 5; ++i)
    g_last_launch[i].store(grid_info[i], std::memory_order_relaxed);
  const dim3 grid((unsigned)groups, (unsigned)n_ct, (unsigned)n_rt);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(src),
                                           static_cast<T*>(out), p);
  return (int)cudaGetLastError();
}

#define HG_ARGS src, out, p, n_ct, n_rt, smem, s
template <typename T, int IF, int WF>
int launch_k(const void* src, void* out, const Plan& p, int n_ct, int n_rt,
             int smem, cudaStream_t s) {
  switch (p.k) {
    case 1: return launch<T, 1, IF, WF>(HG_ARGS);
    case 2: return launch<T, 2, IF, WF>(HG_ARGS);
    case 3: return launch<T, 3, IF, WF>(HG_ARGS);
    case 4: return launch<T, 4, IF, WF>(HG_ARGS);
    default: return launch<T, kMaxTaps, IF, WF>(HG_ARGS);
  }
}

template <typename T>
int launch_forms(const void* src, void* out, const Plan& p, int index_form,
                 int weight_form, int n_ct, int n_rt, int smem,
                 cudaStream_t s) {
  if (weight_form == kFactored)  // rect->hex bilinear: parity, 4 taps
    return launch<T, 4, kParity, kFactored>(HG_ARGS);
  if (index_form == kDense) return launch_k<T, kDense, kPixel>(HG_ARGS);
  if (index_form == kRows) return launch_k<T, kRows, kPixel>(HG_ARGS);
  return launch_k<T, kParity, kPixel>(HG_ARGS);
}
#undef HG_ARGS

}  // namespace

// A plan's tables as kernels/resample.py::GatherTables uploads them, built
// once per table and device on the host (its ctypes twin: _TableArgs).
struct TableArgs {
  const void* idx;
  const void* dk;
  const void* wts;
  const void* rowf;
  const void* colf;
  const void* rowbase;
  const void* tile_row_lo;
  const void* tile_col_lo;
  int h, w, h1, w1, w1p, k, index_form, weight_form, band_rows, band_pitch,
      tile_w;
};

// dtype: 0 = float32, 1 = bfloat16 (source and output share it).
// t: the tables (index_form: 0 dense, 1 rows, 2 parity; weight_form: 0
// pixel, 1 factored; kernels/resample.py::gather_tables), made for this
// dtype's tile (tile_w: 32 lanes x 16 bytes of outputs).  Returns
// cudaGetLastError() of the launch (0 = success), or -1 for arguments the
// kernel does not take.
extern "C" int hg_plan_gather(const void* src, void* out, int dtype,
                              long long n_planes, const TableArgs* t,
                              void* stream) {
  if ((dtype != 0 && dtype != 1) || t == nullptr) return -1;
  const int esz = dtype == 0 ? 4 : 2;
  const int seg = 32 * (16 / esz);
  const int k = t->k, index_form = t->index_form, weight_form = t->weight_form;
  if (k < 1 || k > kMaxTaps || n_planes < 1 || t->h < 1 || t->w < 1 ||
      t->h1 < 1 || t->w1 < 1 || t->tile_w != seg || t->idx == nullptr)
    return -1;
  if (index_form < kDense || index_form > kParity || weight_form < kPixel ||
      weight_form > kFactored)
    return -1;
  if (weight_form == kPixel ? t->wts == nullptr
                            : (index_form != kParity || k != 4 ||
                               t->rowf == nullptr || t->colf == nullptr))
    return -1;
  const bool banded = index_form != kDense;
  if (banded && (t->rowbase == nullptr || t->tile_row_lo == nullptr ||
                 t->tile_col_lo == nullptr || t->band_rows < 1 ||
                 t->band_pitch < 1 || t->band_pitch % (16 / esz) != 0 ||
                 t->band_pitch >= (1 << 15) ||
                 (index_form == kParity && t->dk == nullptr)))
    return -1;
  const long long n_ct = (t->w1 + seg - 1) / seg;
  const long long n_rt = (t->h1 + kWarps - 1) / kWarps;
  if (n_ct > 65535 || n_rt > 65535 || (banded && t->w1p != n_ct * seg))
    return -1;
  // the bands and the output staging; launch() adds the table slice and
  // its mbarrier
  const long long smem =
      (banded ? (long long)kStages * t->band_rows * t->band_pitch * esz : 0) +
      (long long)kWarps * seg * esz;
  if (smem > kSmemMax) return -1;

  Plan p;
  p.idx = t->idx;
  p.dk = static_cast<const uint8_t*>(t->dk);
  p.wts = static_cast<const float*>(t->wts);
  p.rowf = static_cast<const double*>(t->rowf);
  p.colf = static_cast<const double*>(t->colf);
  p.rowbase = static_cast<const int*>(t->rowbase);
  p.tile_row_lo = static_cast<const int*>(t->tile_row_lo);
  p.tile_col_lo = static_cast<const int*>(t->tile_col_lo);
  p.n_planes = n_planes;
  p.h = t->h; p.w = t->w; p.h1 = t->h1; p.w1 = t->w1; p.w1p = t->w1p;
  p.k = k;
  p.band_rows = banded ? t->band_rows : 0;
  p.band_pitch = banded ? t->band_pitch : 0;
  p.planes_per_block = 0;
  p.vec_src = reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
              (t->w * esz) % 16 == 0;
  p.vec_out = reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
              (t->w1 * esz) % 16 == 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_forms<float>(src, out, p, index_form, weight_form,
                               (int)n_ct, (int)n_rt, (int)smem, s);
  return launch_forms<__nv_bfloat16>(src, out, p, index_form, weight_form,
                                     (int)n_ct, (int)n_rt, (int)smem, s);
}

// The last launch's grid into info[5]: plane groups, column tiles, row
// tiles, shared memory bytes and resident blocks an SM (zeros before the
// first launch).  Returns 0.
extern "C" int hg_plan_gather_last_launch(int* info) {
  for (int i = 0; i < 5; ++i)
    info[i] = g_last_launch[i].load(std::memory_order_relaxed);
  return 0;
}
