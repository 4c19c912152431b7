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
// source column outside [0, w) reading 0.  W comes from the weight table:
// (n_phases, n_slots, w1) indexed by phase_idx[r] in phase mode,
// (h1, n_slots, w1) indexed by r when phase_idx is null (dense mode).  The
// TPU pre-stretches (den > 1) or de-interleaves (num > 1) the source so
// that every slot is a static lane slice; here a thread computes its source
// column directly and no copy is made.
//
// What bounds it: memory.  A few FMAs per output value; the bytes are the
// source, the output and, in dense mode, the f32 weight table (7.4 MB at
// the 720p plan, 199 MB at the 4K mosaic: four times that render's bf16
// output).  Design: one thread per output pixel (r, j), consecutive threads
// on consecutive j, so weight, output and (for num <= 2) source accesses
// coalesce.  A thread loads its slot weights and source offsets once, then
// walks a chunk of planes, so the table is read once per chunk of planes.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kMaxSlots = 10;
constexpr int kThreads = 128;

struct Slots {
  int n;
  int d[kMaxSlots];  // row part: source row rowbase[r] + d
  int s[kMaxSlots];  // raw column shift: source column (num*j)/den + s
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
shift_resample_kernel(const T* __restrict__ src, T* __restrict__ out,
                      const int* __restrict__ rowbase,
                      const int* __restrict__ phase_idx,
                      const float* __restrict__ wtab, Slots slots,
                      long long n_planes, int h, int w, int h1, int w1,
                      int num, int den, int planes_per_block) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int r = blockIdx.y;
  if (j >= w1) return;
  const int wrow = phase_idx ? __ldg(phase_idx + r) : r;
  const float* wp = wtab + ((long long)wrow * slots.n) * w1 + j;
  const int base = (int)(((long long)num * j) / den);
  const int rb = __ldg(rowbase + r);
  float wt[kMaxSlots];
  int off[kMaxSlots];
  bool inside[kMaxSlots];
#pragma unroll
  for (int i = 0; i < kMaxSlots; ++i) {
    const int c = base + slots.s[i];
    inside[i] = i < slots.n && c >= 0 && c < w;
    wt[i] = i < slots.n ? __ldg(wp + (long long)i * w1) : 0.f;
    off[i] = inside[i] ? (rb + slots.d[i]) * w + c : 0;
  }
  const long long plane = (long long)h * w;
  const long long out_plane = (long long)h1 * w1;
  const long long n0 = (long long)blockIdx.z * planes_per_block;
  long long n1 = n0 + planes_per_block;
  if (n1 > n_planes) n1 = n_planes;
  for (long long n = n0; n < n1; ++n) {
    const T* s = src + n * plane;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxSlots; ++i)
      if (i < slots.n) acc = fmaf(wt[i], inside[i] ? to_f32(s[off[i]]) : 0.f, acc);
    store(out + n * out_plane + (long long)r * w1 + j, acc);
  }
}

template <typename T>
int launch(const void* src, void* out, const int* rowbase,
           const int* phase_idx, const float* wtab, const Slots& slots,
           long long n_planes, int h, int w, int h1, int w1, int num, int den,
           cudaStream_t stream) {
  // 8 planes per block; more planes grow the chunk so grid.z stays legal
  int ppb = 8;
  while ((n_planes + ppb - 1) / ppb > 65535) ppb *= 2;
  dim3 grid((unsigned)((w1 + kThreads - 1) / kThreads), (unsigned)h1,
            (unsigned)((n_planes + ppb - 1) / ppb));
  shift_resample_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(out), rowbase, phase_idx,
      wtab, slots, n_planes, h, w, h1, w1, num, den, ppb);
  return (int)cudaGetLastError();
}

}  // namespace

// slot_d, slot_s: host arrays of n_slots ints (row part, raw column shift).
// phase_idx: device (h1,) int32, or null for a dense (h1, n_slots, w1)
// table.  dtype: 0 = float32, 1 = bfloat16 (source and output share it).
// Returns cudaGetLastError() of the launch (0 = success), or -1 for
// arguments the kernel does not take.
extern "C" int hg_shift_resample(const void* src, void* out,
                                 const void* rowbase, const void* phase_idx,
                                 const void* wtab, const void* slot_d,
                                 const void* slot_s, int n_slots,
                                 long long n_planes, int h, int w, int h1,
                                 int w1, int num, int den, int dtype,
                                 void* stream) {
  if (n_slots < 1 || n_slots > kMaxSlots || n_planes < 1 || h < 2 || w < 1 ||
      h1 < 1 || h1 > 65535 || w1 < 1 || num < 1 || den < 1)
    return -1;
  if ((long long)h * w > 2147483647LL) return -1;
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
  auto wt = static_cast<const float*>(wtab);
  if (dtype == 0)
    return launch<float>(src, out, rb, ph, wt, slots, n_planes, h, w, h1, w1,
                         num, den, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(src, out, rb, ph, wt, slots, n_planes, h, w,
                                 h1, w1, num, den, s);
  return -1;
}
