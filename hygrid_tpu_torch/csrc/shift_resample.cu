// shift_resample: execute a shift-structured resampling plan on B*C planes.
//
// Replaces: hygrid_tpu/kernels/resample_shift.py::_shift_kernel_full (:215)
// and ::_shift_kernel_banded (:234), both launched by apply_plan_shift
// (:423).  The two TPU kernels compute one function; the banded one copies
// row bands from HBM because the whole source does not fit the TPU's VMEM.
// Hopper has no VMEM to fit, so one kernel covers both.
//
//   out[n, r, j] = sum_i W[i, r, j] * src[n, rowbase[r] + d_i, (num*j)/den + s_i]
//
// over the plan's slots i (at most 10) in their order, f32 accumulation, a
// source column outside [0, w) reading 0.  The TPU pre-stretches (den > 1)
// or de-interleaves (num > 1) the source so that every slot is a static
// lane slice; here a thread computes its source column directly and no copy
// is made.
//
// W comes from the smallest exact form of the plan's weights that
// kernels/resample_shift.py::shift_decompose finds, indexed by the row's
// phase p = phase_idx[r] (r itself for the dense form):
//   select   (form 2): every weight 0 or 1, at most one 1 a pixel (the 4K
//            mosaic): one uint8 slot index a (phase, column), 255 for
//            none; W[i] = (index == i) ? 1 : 0;
//   phase    (form 1): f32 (n_phases, n_slots, w1);
//   dense    (form 0): f32 (h1, n_slots, w1).
// Each form decodes to the same f32 weights, and the FMA chain over every
// slot is the same, so every form gives the dense table's result bit for
// bit (non-finite sources included: a zero weight still multiplies its
// value).
//
// What bounds it: memory.  A few FMAs per output value; the bytes are the
// source, the output and the weight table.  At the 4K mosaic a dense f32
// table would be 199 MB, four times that render's bf16 output; the select
// table is 2.1 MB and stays in the L2, so the output bounds the kernel.
// Design:
// where the column stride num is 1 each thread computes kPix = 4
// consecutive output pixels of one row (one 16- or 8-byte store for
// float32 or bfloat16 where the row allows); at den a multiple of 4 (the
// mosaic) they share their source column, so each slot is read once for
// the four.  Where num > 1 consecutive pixels lie num source columns
// apart, so a thread computes one pixel and consecutive threads read
// neighbouring columns.  A thread decodes its pixels' slot weights once,
// then for each plane of its chunk issues every slot's source load (the
// read-only path) before the FMA chain, so the table is read once per
// chunk of planes and the loads overlap.  The layouts are separate
// instantiations, so that each keeps only its own registers.
#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kMaxSlots = 10;
constexpr int kThreads = 128;
constexpr int kPix = 4;        // consecutive output pixels a thread
constexpr int kDense = 0, kPhase = 1, kSelect = 2;
constexpr int kSelectNone = 255;

struct Slots {
  int n;
  int d[kMaxSlots];  // row part: source row rowbase[r] + d
  int s[kMaxSlots];  // raw column shift: source column (num*j)/den + s
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// kPix consecutive outputs in one store (16 bytes of float32, 8 of bf16)
__device__ __forceinline__ void store4(float* p, const float (&v)[kPix]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&v)[kPix]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// The kernel.  kSel: the select form (a slot index a pixel, decoded at
// each FMA); otherwise the pixels' float32 slot weights are loaded once.
// kPixT consecutive output pixels a thread (kPix where num = 1, 1 where
// num > 1); kShared: they share their source column (num = 1, den a
// multiple of kPix), so the slots are read once for all of them.
template <typename T, bool kSel, int kPixT, bool kShared>
__global__ void __launch_bounds__(kThreads)
shift_resample_kernel(const T* __restrict__ src, T* __restrict__ out,
                      const int* __restrict__ rowbase,
                      const int* __restrict__ phase_idx,
                      const void* __restrict__ wtab, Slots slots, int form,
                      long long n_planes, int h, int w, int h1, int w1,
                      int num, int den, int planes_per_block, int vec) {
  const int j0 = (blockIdx.x * kThreads + threadIdx.x) * kPixT;
  const int r = blockIdx.y;
  if (j0 >= w1) return;
  const int wrow = form == kDense ? r : __ldg(phase_idx + r);
  const int rb = __ldg(rowbase + r);
  // the slot weights (or slot index) of this thread's pixels, decoded once
  float wt[kSel ? 1 : kPixT][kMaxSlots];
  int sel[kPixT];
  int base[kPixT];
#pragma unroll
  for (int p = 0; p < kPixT; ++p) {
    const int j = j0 + p < w1 ? j0 + p : w1 - 1;   // past the row: unused
    base[p] = num * (j0 + p) / den;
    if constexpr (kSel) {
      sel[p] = __ldg(static_cast<const uint8_t*>(wtab) +
                     (long long)wrow * w1 + j);
    } else {
      const float* wp = static_cast<const float*>(wtab) +
                        (long long)wrow * slots.n * w1 + j;
#pragma unroll
      for (int i = 0; i < kMaxSlots; ++i)
        wt[p][i] = i < slots.n ? __ldg(wp + (long long)i * w1) : 0.f;
    }
  }
  const long long plane = (long long)h * w;
  const long long out_plane = (long long)h1 * w1;
  const long long n0 = (long long)blockIdx.z * planes_per_block;
  long long n1 = n0 + planes_per_block;
  if (n1 > n_planes) n1 = n_planes;
  const bool whole = kPixT == kPix && vec && j0 + kPix <= w1;
  for (long long n = n0; n < n1; ++n) {
    const T* row = src + n * plane + (long long)rb * w;   // row part 0
    // the slots' source values at column base b + s_i, all loads issued
    // before the FMA chain reads them
    auto gather = [&](float (&v)[kMaxSlots], int b) {
#pragma unroll
      for (int i = 0; i < kMaxSlots; ++i) {
        const int c = b + slots.s[i];
        v[i] = i < slots.n && c >= 0 && c < w
                   ? load(row + slots.d[i] * w + c) : 0.f;
      }
    };
    // the FMA chain of pixel p over the slots, in order
    auto chain = [&](const float (&v)[kMaxSlots], int p) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxSlots; ++i) {
        float wi;
        if constexpr (kSel)
          wi = i == sel[p] ? 1.f : 0.f;
        else
          wi = wt[p][i];
        if (i < slots.n) acc = fmaf(wi, v[i], acc);
      }
      return acc;
    };
    float acc[kPix];
    float v[kMaxSlots];
    if constexpr (kShared) {
      gather(v, base[0]);
#pragma unroll
      for (int p = 0; p < kPixT; ++p) acc[p] = chain(v, p);
    } else {
#pragma unroll
      for (int p = 0; p < kPixT; ++p) {
        gather(v, base[p]);
        acc[p] = chain(v, p);
      }
    }
    T* o = out + n * out_plane + (long long)r * w1 + j0;
    if (whole) {
      store4(o, acc);
    } else {
#pragma unroll
      for (int p = 0; p < kPixT; ++p)
        if (j0 + p < w1) store(o + p, acc[p]);
    }
  }
}

template <typename T, bool kSel>
int launch(const void* src, void* out, const int* rowbase,
           const int* phase_idx, const void* wtab, const Slots& slots,
           int form, long long n_planes, int h, int w, int h1, int w1,
           int num, int den, cudaStream_t stream) {
  // 8 planes per block; more planes grow the chunk so grid.z stays legal
  int ppb = 8;
  while ((n_planes + ppb - 1) / ppb > 65535) ppb *= 2;
  // kPix outputs in one store where every thread's first lies on the
  // store's alignment (the plane and row starts do when w1 % kPix == 0)
  const int vec = w1 % kPix == 0 &&
                  reinterpret_cast<uintptr_t>(out) % (kPix * sizeof(T)) == 0;
  // a column stride num > 1 spreads consecutive pixels over num source
  // columns each: one pixel a thread keeps a warp's reads together
  const int pix = num > 1 ? 1 : kPix;
  auto kernel = num > 1 ? shift_resample_kernel<T, kSel, 1, false>
                : den % kPix == 0 ? shift_resample_kernel<T, kSel, kPix, true>
                                  : shift_resample_kernel<T, kSel, kPix, false>;
  const int per_block = kThreads * pix;
  dim3 grid((unsigned)((w1 + per_block - 1) / per_block), (unsigned)h1,
            (unsigned)((n_planes + ppb - 1) / ppb));
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(out), rowbase, phase_idx,
      wtab, slots, form, n_planes, h, w, h1, w1, num, den, ppb, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_form(const void* src, void* out, const int* rowbase,
                const int* phase_idx, const void* wtab, const Slots& slots,
                int form, long long n_planes, int h, int w, int h1, int w1,
                int num, int den, cudaStream_t stream) {
  if (form == kSelect)
    return launch<T, true>(src, out, rowbase, phase_idx, wtab, slots, form,
                           n_planes, h, w, h1, w1, num, den, stream);
  return launch<T, false>(src, out, rowbase, phase_idx, wtab, slots, form,
                          n_planes, h, w, h1, w1, num, den, stream);
}

}  // namespace

// wtab: the weight table of `form` (0 dense f32 (h1, n_slots, w1), 1 phase
// f32 (n_phases, n_slots, w1), 2 select uint8 (n_phases, w1)); phase_idx:
// device (h1,) int32, null only for the dense form.  slot_d, slot_s: host arrays of
// n_slots ints (row part, raw column shift).  dtype: 0 = float32,
// 1 = bfloat16 (source and output share it).  Returns cudaGetLastError()
// of the launch (0 = success), or -1 for arguments the kernel does not
// take.
extern "C" int hg_shift_resample(const void* src, void* out,
                                 const void* rowbase, const void* phase_idx,
                                 const void* wtab, int form,
                                 const void* slot_d, const void* slot_s,
                                 int n_slots,
                                 long long n_planes, int h, int w, int h1,
                                 int w1, int num, int den, int dtype,
                                 void* stream) {
  if (n_slots < 1 || n_slots > kMaxSlots || n_planes < 1 || h < 2 || w < 1 ||
      h1 < 1 || h1 > 65535 || w1 < 1 || num < 1 || den < 1)
    return -1;
  if ((long long)h * w > 2147483647LL) return -1;
  if (form < kDense || form > kSelect || (form != kDense && !phase_idx))
    return -1;
  if (form == kSelect && n_slots >= kSelectNone) return -1;
  Slots slots;
  slots.n = n_slots;
  for (int i = 0; i < kMaxSlots; ++i) {
    slots.d[i] = i < n_slots ? static_cast<const int*>(slot_d)[i] : 0;
    slots.s[i] = i < n_slots ? static_cast<const int*>(slot_s)[i] : 0;
    if (slots.d[i] < 0 || slots.d[i] > 1) return -1;
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto rb = static_cast<const int*>(rowbase);
  auto ph = static_cast<const int*>(phase_idx);
  if (dtype == 0)
    return launch_form<float>(src, out, rb, ph, wtab, slots, form, n_planes,
                              h, w, h1, w1, num, den, s);
  if (dtype == 1)
    return launch_form<__nv_bfloat16>(src, out, rb, ph, wtab, slots, form,
                                      n_planes, h, w, h1, w1, num, den, s);
  return -1;
}
