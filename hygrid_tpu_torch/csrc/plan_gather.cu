// plan_gather: execute a resampling plan (gather + blend) on B*C planes.
//
// Replaces: hygrid_tpu/kernels/resample_pallas.py::_resample_kernel (with
// _tile_body), launched by _apply_plan_pallas_impl.  It computes the same
// function as the TPU's banded and phased variants (_resample_kernel_banded,
// _resample_kernel_phased, _resample_kernel_phased_banded) and the shift
// executor (resample_shift.py), which exist to fit the TPU's VMEM and MXU.
//
//   out[n, p] = sum_k w[k, p] * src[n, idx[k, p]]      (f32 accumulation)
//
// idx is the plan's flat source index i*W + j (int32, already clamped into
// range), w its float32 weights; n runs over the planes, p over the h1*w1
// output pixels.  The TPU builds one-hot selection matrices for the MXU;
// on Hopper the gather is a plain indexed load.
//
// What bounds it: memory.  At the HexCNN-512 leg (rect->hex 512^2->256^2,
// bilinear K=4, 96 planes) it does 4 FMAs per output value and moves one
// plane of source and a quarter plane of output per plane: far below the
// card's FLOP/byte balance.  The design goal is to read each source byte
// once per chunk of planes and the plan once per chunk: one thread owns one
// output pixel, loads its K indices and weights into registers once, then
// walks PLANES_PER_BLOCK planes.  Neighbouring threads own neighbouring
// output pixels, whose source taps are neighbouring too for the row-
// separable plans the geometry ops build, so the gathers coalesce into few
// sectors.  Both the plain version and this kernel keep the weights in f32
// and accumulate in f32 also for bf16 images.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kMaxTaps = 8;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
plan_gather_kernel(const T* __restrict__ src, T* __restrict__ out,
                   const int* __restrict__ idx, const float* __restrict__ w,
                   long long n_planes, long long src_plane, long long n_out,
                   int k, int planes_per_block) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= n_out) return;
  int id[kMaxTaps];
  float wt[kMaxTaps];
#pragma unroll
  for (int t = 0; t < kMaxTaps; ++t) {
    id[t] = t < k ? __ldg(idx + t * n_out + p) : 0;
    wt[t] = t < k ? __ldg(w + t * n_out + p) : 0.f;
  }
  const long long n0 = (long long)blockIdx.y * planes_per_block;
  long long n1 = n0 + planes_per_block;
  if (n1 > n_planes) n1 = n_planes;
  for (long long n = n0; n < n1; ++n) {
    const T* s = src + n * src_plane;
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxTaps; ++t)
      if (t < k) acc = fmaf(wt[t], to_f32(s[id[t]]), acc);
    store(out + n * n_out + p, acc);
  }
}

template <typename T>
int launch(const void* src, void* out, const int* idx, const float* w,
           long long n_planes, long long src_plane, long long n_out, int k,
           cudaStream_t stream) {
  // 8 planes per block keeps ~3k blocks in flight at the HexCNN shape;
  // larger plane counts grow the chunk so grid.y stays under 65535
  int ppb = 8;
  while ((n_planes + ppb - 1) / ppb > 65535) ppb *= 2;
  dim3 grid((unsigned)((n_out + kThreads - 1) / kThreads),
            (unsigned)((n_planes + ppb - 1) / ppb));
  plan_gather_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(out), idx, w, n_planes,
      src_plane, n_out, k, ppb);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (source and output share it).
// Returns cudaGetLastError() of the launch (0 = success), or -1 for
// arguments the kernel does not take.
extern "C" int hg_plan_gather(const void* src, void* out, const void* idx,
                              const void* w, long long n_planes,
                              long long src_plane, long long n_out, int k,
                              int dtype, void* stream) {
  if (k < 1 || k > kMaxTaps || n_planes < 1 || n_out < 1) return -1;
  if ((n_out + kThreads - 1) / kThreads > 2147483647LL) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const int*>(idx);
  auto f = static_cast<const float*>(w);
  if (dtype == 0)
    return launch<float>(src, out, i, f, n_planes, src_plane, n_out, k, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(src, out, i, f, n_planes, src_plane, n_out,
                                 k, s);
  return -1;
}
