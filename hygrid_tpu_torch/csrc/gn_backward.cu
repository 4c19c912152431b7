// gn_backward: the backward of a GroupNorm layer's tail, out =
// act(GroupNorm(y)), for kernel B's GN layers and the split layer (the same
// torch.autograd.Function, kernels/conv_stack.py::_HexConvLayer).
//
// Replaces: the reference's pullback of that tail, jax.vjp of
// conv_pallas.py::_make_post (:1752-1800), taken at conv_pallas.py:2023-2029
// and run by XLA: it is not a Pallas kernel.  It computes the closed-form
// vjp of the same function, with the statistics the forward saved
// (hex_conv_layer.cu's stats fold: mean and rstd per (sample, group), var =
// E[y^2] - mean^2 clamped at 0):
//
//   scale = rstd gamma, shift = beta - mean scale (the forward's own, each
//           product and difference rounded alone),
//   dz    = gout where fmaf(y, scale, shift) > 0 (ReLU; all of gout without),
//   yhat  = (y - mean) rstd,
//   A     = sum_{c in g} gamma_c sum_pixels dz,
//   Bs    = sum_{c in g} gamma_c sum_pixels dz yhat,
//   gpre  = scale dz - (rstd A / n + f rstd Bs / n yhat),
//
// n = pixels x channels per group, f = 0 where the variance sat at the
// clamp (rstd = eps^-1/2), else 1; dgamma = sum dz yhat, dbeta = sum dz over
// samples and pixels; dbias = sum gpre (float32, before the round to the
// activation dtype, as the bias's cotangent is summed from the float32
// pre-activation cotangent).
//
// What bounds it: bytes.  Four launches, two of them passes over (y, gout):
//   1. gn_bwd_reduce_kernel: per (chunk of pixels, sample) block, sums of dz
//      and dz yhat per channel;
//   2. gn_bwd_fold_kernel: per sample, the chunks in order, then A and Bs per
//      group;
//   3. gn_bwd_apply_kernel: gpre in the activation dtype, and the block's
//      per-channel sums of the float32 gpre;
//   4. gn_bwd_final_kernel: per channel, dgamma, dbeta and dbias in a fixed
//      order.
// The passes read y (float32) and gout twice and write gpre once: 14 bytes
// an element in bf16, where the function needs 8 (each input once); the
// folds move (B, chunks, C) partial sums, a few hundred KB.  Both passes use
// hg::GnLayout: each thread keeps V channels for its run of pixels, 16-byte
// loads and stores, no integer divide an element.  No atomics: every sum has
// a fixed order, so repeated launches are bit-equal.
#include "hex_common.cuh"

namespace {

// A pairwise tree over the k rows of red ([k][n] floats, row-major): thread
// (row, col) adds its V columns; red[0][*] holds the sums after it.  Every
// thread of the block calls it.
template <int V>
__device__ __forceinline__ void row_tree(float* red, int n, int k, int row,
                                         int col) {
  for (int st = 1; st < k; st *= 2) {
    __syncthreads();
    if (row % (2 * st) == 0 && row + st < k)
#pragma unroll
      for (int i = 0; i < V; ++i)
        red[row * n + col + i] += red[(row + st) * n + col + i];
  }
  __syncthreads();
}

// Per-thread constants of channels c .. c + V - 1 of sample b.
template <int V>
struct GnChannels {
  float mean[V], rstd[V], scale[V], shift[V];
  __device__ GnChannels(const float* __restrict__ stats,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta, int b, int c, int G,
                        int cpg) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float* st = stats + 2 * ((long long)b * G + (c + i) / cpg);
      mean[i] = st[0];
      rstd[i] = st[1];
      scale[i] = rstd[i] * gamma[c + i];
      // rounded twice, not fused: the forward's shift (gn_apply_kernel)
      shift[i] = __fsub_rn(beta[c + i], __fmul_rn(mean[i], scale[i]));
    }
  }
};

// dz of one element: gout where the forward's output was positive
__device__ __forceinline__ float masked(float g, float y, float scale,
                                        float shift, int relu) {
  return relu && !(fmaf(y, scale, shift) > 0.f) ? 0.f : g;
}

// Block (chunk, sample): partial (B, n_chunks, C, 2) = (sum dz, sum dz yhat)
// over the chunk's px pixels.  Dynamic shared memory: 2 x threads x V
// floats.
template <int V, typename Tg>
__global__ void __launch_bounds__(V == 1 ? 1024 : 256)
gn_bwd_reduce_kernel(const float* __restrict__ y, const Tg* __restrict__ gout,
                     const float* __restrict__ stats,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     float* __restrict__ partial, long long HW, int C, int G,
                     int px, int relu) {
  extern __shared__ float red[];               // [2][k][C]
  const int cvs = C / V, k = blockDim.x / cvs;
  const int row = threadIdx.x / cvs, c = (threadIdx.x % cvs) * V;
  const int b = blockIdx.y;
  const GnChannels<V> ch(stats, gamma, beta, b, c, G, C / G);
  float sd[V], sdy[V];
#pragma unroll
  for (int i = 0; i < V; ++i) sd[i] = sdy[i] = 0.f;
  const long long p0 = (long long)blockIdx.x * px;
  const long long p1 = p0 + px < HW ? p0 + px : HW;
  const long long base = (long long)b * HW * C + c;
  for (long long p = p0 + row; p < p1; p += k) {
    float yv[V], gv[V];
    hg::load_vec<V>(y + base + p * C, yv);
    hg::load_vec<V>(gout + base + p * C, gv);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float d = masked(gv[i], yv[i], ch.scale[i], ch.shift[i], relu);
      sd[i] += d;
      sdy[i] = fmaf(d, (yv[i] - ch.mean[i]) * ch.rstd[i], sdy[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    red[row * C + c + i] = sd[i];
    red[(k + row) * C + c + i] = sdy[i];
  }
  row_tree<V>(red, C, k, row, c);
  row_tree<V>(red + k * C, C, k, row, c);
  if (row == 0) {
    float* out = partial + ((long long)b * gridDim.x + blockIdx.x) * C * 2;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      out[2 * (c + i)] = red[c + i];
      out[2 * (c + i) + 1] = red[k * C + c + i];
    }
  }
}

// Block b, C x slices threads (thread t: channel t % C, chunks t / C, +
// slices, ...): sums (B, C, 2) = the sample's (sum dz, sum dz yhat) per
// channel, the chunks folded as a strided run then a tree over the slices;
// then coef (B, G, 2) = (rstd A / n, f rstd Bs / n) per group, its channels
// in order.  Dynamic shared memory: 2 x slices x C floats.
__global__ void __launch_bounds__(1024)
gn_bwd_fold_kernel(const float* __restrict__ partial,
                   const float* __restrict__ stats,
                   const float* __restrict__ gamma, float* __restrict__ sums,
                   float* __restrict__ coef, int n_chunks, int C, int G,
                   float count, float eps) {
  extern __shared__ float red[];               // [2][slices][C]
  const int slices = blockDim.x / C;
  const int c = threadIdx.x % C, sl = threadIdx.x / C;
  const int b = blockIdx.x;
  float sd = 0.f, sdy = 0.f;
  for (int ch = sl; ch < n_chunks; ch += slices) {
    const float* p = partial + (((long long)b * n_chunks + ch) * C + c) * 2;
    sd += p[0];
    sdy += p[1];
  }
  red[sl * C + c] = sd;
  red[(slices + sl) * C + c] = sdy;
  row_tree<1>(red, C, slices, sl, c);
  row_tree<1>(red + slices * C, C, slices, sl, c);
  if (sl == 0) {
    sums[((long long)b * C + c) * 2] = red[c];
    sums[((long long)b * C + c) * 2 + 1] = red[slices * C + c];
  }
  const int cpg = C / G;
  const float rstd_eps = rsqrtf(eps);     // rstd where the variance sat at 0
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float a = 0.f, bs = 0.f;
    for (int cc = g * cpg; cc < (g + 1) * cpg; ++cc) {
      a = fmaf(gamma[cc], red[cc], a);
      bs = fmaf(gamma[cc], red[slices * C + cc], bs);
    }
    const float rstd = stats[2 * ((long long)b * G + g) + 1];
    const float f = rstd < rstd_eps ? 1.f : 0.f;
    coef[2 * ((long long)b * G + g)] = rstd * a / count;
    coef[2 * ((long long)b * G + g) + 1] = f * rstd * bs / count;
  }
}

// Block (chunk, sample), as the reduce pass: gpre and bpart (B, n_chunks,
// C), the chunk's per-channel sums of the float32 gpre.  Dynamic shared
// memory: threads x V floats.
template <int V, typename Tg>
__global__ void __launch_bounds__(V == 1 ? 1024 : 256)
gn_bwd_apply_kernel(const float* __restrict__ y, const Tg* __restrict__ gout,
                    const float* __restrict__ stats,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta,
                    const float* __restrict__ coef, Tg* __restrict__ gpre,
                    float* __restrict__ bpart, long long HW, int C, int G,
                    int px, int relu) {
  extern __shared__ float red[];               // [k][C]
  const int cvs = C / V, k = blockDim.x / cvs;
  const int row = threadIdx.x / cvs, c = (threadIdx.x % cvs) * V;
  const int b = blockIdx.y, cpg = C / G;
  const GnChannels<V> ch(stats, gamma, beta, b, c, G, cpg);
  float a1[V], a2[V], bs[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float* cf = coef + 2 * ((long long)b * G + (c + i) / cpg);
    a1[i] = cf[0];
    a2[i] = cf[1];
    bs[i] = 0.f;
  }
  const long long p0 = (long long)blockIdx.x * px;
  const long long p1 = p0 + px < HW ? p0 + px : HW;
  const long long base = (long long)b * HW * C + c;
  for (long long p = p0 + row; p < p1; p += k) {
    float yv[V], gv[V];
    hg::load_vec<V>(y + base + p * C, yv);
    hg::load_vec<V>(gout + base + p * C, gv);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float d = masked(gv[i], yv[i], ch.scale[i], ch.shift[i], relu);
      const float yh = (yv[i] - ch.mean[i]) * ch.rstd[i];
      gv[i] = fmaf(ch.scale[i], d, -fmaf(a2[i], yh, a1[i]));
      bs[i] += gv[i];
    }
    hg::store_vec<V>(gpre + base + p * C, gv);
  }
#pragma unroll
  for (int i = 0; i < V; ++i) red[row * C + c + i] = bs[i];
  row_tree<V>(red, C, k, row, c);
  if (row == 0) {
    float* out = bpart + ((long long)b * gridDim.x + blockIdx.x) * C;
#pragma unroll
    for (int i = 0; i < V; ++i) out[c + i] = red[c + i];
  }
}

// Block c, 256 threads: grads (3, C) = dgamma, dbeta (sums over samples)
// and dbias (over samples x chunks), each a strided run then a tree.
__global__ void __launch_bounds__(256)
gn_bwd_final_kernel(const float* __restrict__ sums,
                    const float* __restrict__ bpart, float* __restrict__ grads,
                    int B, int n_chunks, int C) {
  __shared__ float red[3][256];
  const int c = blockIdx.x, t = threadIdx.x;
  float dg = 0.f, dbt = 0.f, db = 0.f;
  for (int b = t; b < B; b += 256) {
    dbt += sums[((long long)b * C + c) * 2];
    dg += sums[((long long)b * C + c) * 2 + 1];
  }
  const long long n = (long long)B * n_chunks;
  for (long long e = t; e < n; e += 256) db += bpart[e * C + c];
  red[0][t] = dg;
  red[1][t] = dbt;
  red[2][t] = db;
  for (int st = 128; st > 0; st /= 2) {
    __syncthreads();
    if (t < st)
      for (int j = 0; j < 3; ++j) red[j][t] += red[j][t + st];
  }
  if (t == 0)
    for (int j = 0; j < 3; ++j) grads[j * C + c] = red[j][0];
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// The backward of act(GroupNorm(y)).  y: float32 (B, HW, C) NHWC, the
// layer's pre-activation (bias included); gout and gpre: (B, HW, C) of
// `dtype` (0 = float32, 1 = bfloat16); stats: float32 (B, G, 2) mean and
// rstd as the forward saved them; gamma, beta: float32 (C,); scratch:
// n_scratch = B x n_chunks x C x 3 + B x C x 2 + B x G x 2 float32; grads:
// float32 (3, C) = dgamma, dbeta, dbias.  Returns the first non-zero
// cudaGetLastError() of its launches, or -1 for arguments it does not take.
extern "C" int hg_gn_relu_backward(
    const void* y, const void* gout, const void* stats, const void* gamma,
    const void* beta, void* scratch, long long n_scratch, void* gpre,
    void* grads, int dtype, int B, long long HW, int C, int G, int n_chunks,
    int relu, float eps, void* stream) {
  if (B < 1 || B > 65535 || HW < 1 || C < 1 || C > 1024 || G < 1 ||
      C % G || n_chunks < 1 || n_chunks > HW || (dtype != 0 && dtype != 1) ||
      !y || !gout || !stats || !gamma || !beta || !scratch || !gpre ||
      !grads)
    return -1;
  const long long chunked = (long long)B * n_chunks * C;
  if (n_scratch != 3 * chunked + 2LL * B * C + 2LL * B * G) return -1;
  float* partial = static_cast<float*>(scratch);          // (B, chunks, C, 2)
  float* bpart = partial + 2 * chunked;                   // (B, chunks, C)
  float* sums = bpart + chunked;                          // (B, C, 2)
  float* coef = sums + 2LL * B * C;                       // (B, G, 2)
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const hg::GnLayout lay = hg::gn_layout(
      C, aligned16(y) && aligned16(gout) && aligned16(gpre));
  const dim3 grid(n_chunks, B);
  const int threads = lay.threads();
  const int px = (int)((HW + n_chunks - 1) / n_chunks);
  const int slices = C >= 256 ? 1 : 256 / C;
  auto run = [&](auto tg) {
    using Tg = decltype(tg);
    const Tg* g = static_cast<const Tg*>(gout);
    int err = hg::dispatch_v(lay.V, [&](auto v) {
      constexpr int V = decltype(v)::value;
      gn_bwd_reduce_kernel<V, Tg>
          <<<grid, threads, 2 * threads * V * sizeof(float), s>>>(
              f(y), g, f(stats), f(gamma), f(beta), partial, HW, C, G, px,
              relu);
      return (int)cudaGetLastError();
    });
    if (err) return err;
    gn_bwd_fold_kernel<<<B, C * slices, 2 * slices * C * sizeof(float), s>>>(
        partial, f(stats), f(gamma), sums, coef, n_chunks, C, G,
        (float)(HW * (C / G)), eps);
    if ((err = (int)cudaGetLastError())) return err;
    err = hg::dispatch_v(lay.V, [&](auto v) {
      constexpr int V = decltype(v)::value;
      gn_bwd_apply_kernel<V, Tg><<<grid, threads, threads * V * sizeof(float),
                                   s>>>(
          f(y), g, f(stats), f(gamma), f(beta), coef,
          static_cast<Tg*>(gpre), bpart, HW, C, G, px, relu);
      return (int)cudaGetLastError();
    });
    if (err) return err;
    gn_bwd_final_kernel<<<C, 256, 0, s>>>(sums, bpart,
                                          static_cast<float*>(grads), B,
                                          n_chunks, C);
    return (int)cudaGetLastError();
  };
  return dtype == 0 ? run(float{}) : run(__nv_bfloat16{});
}
