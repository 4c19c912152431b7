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
// What bounds it: bytes.  The function reads y (float32) and gout once and
// writes gpre once: 8 bytes an element in bf16.  A sample's gpre needs the
// sample's sums over all of (y, gout), so a kernel that keeps nothing on
// chip reads both twice (14 bytes an element).  This one reads them once:
//
//   * One cooperative launch (every block resident) walks (sample, chunk of
//     pixels) items in sample-major waves: a wave is as many samples as the
//     blocks' shared memory holds, one chunk a block
//     (kernels/conv_stack.py::gn_backward_plan chooses chunk, samples a wave
//     and stages from the card's SMs and shared memory).
//   * A block stages its chunk of y and gout, and the sample's statistics,
//     in shared memory with cp.async; with two stages the next wave's chunk
//     copies while this wave runs.  It sums (dz yhat, dz) per channel from
//     there (vectors of V channels a thread, warp shuffles, then the rows
//     left), writes them to its partial slot and arrives at the sample's
//     counter.
//   * Once the counter shows every chunk, each block of the sample folds the
//     partials in chunk order (the same sums in every block: one read of
//     the partials instead of a last block's fold, a flag and a read of its
//     result), computes the per-group (rstd A / n, f rstd Bs / n), then gpre
//     from its staged copy, not from device memory.  Its float32 gpre sums
//     run on across its waves; the last block to finish folds the samples'
//     dgamma and dbeta and the blocks' dbias, in order.
//
// A wave costs its sums' trip through L2 (the partial's stores, the counter,
// its readers' loads) as well as its bytes, and the trip is slow while the
// next wave's copies fill the memory system: a release waits for its warp's
// earlier memory operations, so warp 0, which arrives, copies nothing.
// Where a sample is larger than the blocks' shared memory, each chunk stages
// what fits and reads the rest from device memory in both passes.  The
// counters are cleared on the stream before the launch (a memset, no
// kernel), so a call is one launch, takes no host synchronisation and can be
// captured in a CUDA graph.  Every sum has a fixed order (no float atomics),
// so repeated launches are bit-equal.
#include "hex_common.cuh"

namespace {

constexpr int kThreads = 512;     // a block's threads where V > 1

__host__ __device__ inline long long pad16(long long n) {
  return (n + 15) / 16 * 16;
}

// The block, as hg::GnLayout lays out the GN passes: vectors of V channels
// (4 here, whole 16-byte float32 loads), cvs of them a pixel, k pixel rows
// (conv_stack.py::gn_backward_layout); `rows` rows of per-channel sums are
// left after the warp shuffles (one a warp where a warp's lanes hold whole
// pixel rows, else one a pixel row).
struct Layout {
  int V, cvs, k, threads, rows;
  bool shuffle;
};

Layout layout(int C, bool aligned) {
  Layout l;
  l.V = aligned && C % 4 == 0 ? 4 : 1;
  l.cvs = C / l.V;
  l.k = l.cvs >= kThreads ? 1 : kThreads / l.cvs;
  l.threads = l.cvs * l.k;
  l.shuffle = l.cvs < 32 && 32 % l.cvs == 0;
  l.rows = l.shuffle ? l.threads / 32 : l.k;
  return l;
}

// One stage (a chunk's y, its gout, then the sample's mean and rstd a
// group, C floats each) and the block's shared memory: stages, the
// reduction rows (at least 4 floats a thread, the folds' slices), the
// final step's flag (16 bytes), the sample's per-channel sums and
// per-group coefficients (2 C floats each) and gamma (C floats).
long long stage_bytes(long long staged_px, int C, int gb) {
  return pad16(staged_px * C * 4) + pad16(staged_px * C * gb) + pad16(8LL * C);
}
long long red_floats(int C, const Layout& l) {
  const long long r = 2LL * l.rows * C;
  return r > 4LL * l.threads ? r : 4LL * l.threads;
}
long long smem_bytes(int C, int gb, const Layout& l, long long staged_px,
                     int stages) {
  return stages * stage_bytes(staged_px, C, gb) + pad16(4 * red_floats(C, l)) +
         16 + 20LL * C;
}

template <typename Tg>
struct Args {
  const float* y;
  const Tg* gout;
  const float* mean;
  const float* rstd;
  const float* gamma;
  const float* beta;
  Tg* gpre;
  float* grads;      // (3, C): dgamma, dbeta, dbias
  float* partial;    // (B, chunks, 2, C): sum dz yhat, sum dz of a chunk
  float* sums;       // (B, 2, C): a sample's dgamma, dbeta parts
  float* bpart;      // (grid, C): sum gpre of a block's items
  unsigned* arrive;  // (B): chunks summed
  unsigned* done;    // (1): blocks through every wave
  long long HW, stage_bytes, gout_off, stats_off, red_floats;
  int stat_stride, B, C, G, relu, chunk_px, staged_px, chunks, spw, waves,
      stages, vec, rows, shuffle;
  float count, eps;
};

// The arrival and wait of a split barrier at gpu scope (as CUTLASS's
// GenericBarrier): after the writing threads, thread 0 adds with release
// semantics; a waiter's thread 0 spins with acquire loads, then the block
// passes a barrier.  A release waits for its warp's earlier memory
// operations, so the arriving warp (warp 0) issues none of the next wave's
// copies.
__device__ __forceinline__ void arrive(unsigned* counter) {
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n"
                 :: "l"(counter), "r"(1u) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A wait past some seconds means a broken walk: trap (a launch error)
// rather than hang the device.
__device__ __forceinline__ void wait_for(const unsigned* counter,
                                         unsigned count) {
  if (threadIdx.x == 0)
    for (unsigned spins = 0; ld_acquire(counter) < count; ++spins) {
      if (spins > (1u << 28)) __trap();
      __nanosleep(20);
    }
  __syncthreads();
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}

// The slices' sums of a fold: slice s of the block's threads holds in acc
// the VW floats of its column i (of w); dst[e] (e < w VW) = the sum over the
// slices, in two levels through red (4 blockDim.x floats).  Every thread
// calls it.
template <int VW>
__device__ __forceinline__ void sum_slices(const float (&acc)[VW], int s,
                                           int i, int slices, int w,
                                           float* dst, float* red) {
  const int T = blockDim.x, t = threadIdx.x, m = w * VW;
  __syncthreads();
  if (s < slices)
#pragma unroll
    for (int v = 0; v < VW; ++v) red[s * m + i * VW + v] = acc[v];
  __syncthreads();
  // slice groups: (g, e) adds slices g, g + g1, ... into slice g
  const int g1 = T / m < slices ? (T / m > 0 ? T / m : 1) : slices;
  for (int x = t; x < g1 * m; x += T) {
    const int g = x / m, e = x % m;
    float sum = 0.f;
    for (int sl = g; sl < slices; sl += g1) sum += red[sl * m + e];
    red[g * m + e] = sum;
  }
  __syncthreads();
  for (int e = t; e < m; e += T) {
    float sum = 0.f;
    for (int g = 0; g < g1; ++g) sum += red[g * m + e];
    dst[e] = sum;
  }
}

// dst[i] = sum over r < rows of src[r * n + i], i < n, in a fixed order:
// slice s of the block's threads sums rows s, s + slices, ... in turn (VW
// floats a load, neighbouring threads on neighbouring columns), then the
// slices (sum_slices).  src was written by other blocks (read through L2).
// Every thread calls it; dst is complete after it.
template <int VW>
__device__ void fold_vec(const float* src, long long rows, int n, float* dst,
                         float* red) {
  const int T = blockDim.x, t = threadIdx.x, cols = n / VW;
  for (int c0 = 0; c0 < cols; c0 += T) {
    const int w = cols - c0 < T ? cols - c0 : T, slices = T / w;
    const int i = t % w, s = t / w;
    float acc[VW];
#pragma unroll
    for (int v = 0; v < VW; ++v) acc[v] = 0.f;
    if (s < slices) {
      const float* p = src + (long long)(c0 + i) * VW;
#pragma unroll 8
      for (long long r = s; r < rows; r += slices) {
        if constexpr (VW == 4) {
          const float4 q = __ldcg(reinterpret_cast<const float4*>(p + r * n));
          acc[0] += q.x, acc[1] += q.y, acc[2] += q.z, acc[3] += q.w;
        } else {
          acc[0] += __ldcg(p + r * n);
        }
      }
    }
    sum_slices<VW>(acc, s, i, slices, w, dst + c0 * VW, red);
  }
  __syncthreads();
}

__device__ void fold_rows(const float* src, long long rows, int n,
                          float* dst, float* red) {
  if (n % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0)
    fold_vec<4>(src, rows, n, dst, red);
  else
    fold_vec<1>(src, rows, n, dst, red);
}

// The block's per-channel sums of NQ quantities q[j][0 .. V-1] (channels
// c .. c + V - 1 of the thread's pixel row): lanes of a warp that hold the
// same channels add by xor shuffles, then the rows left are summed in
// order, by one thread a (quantity, channel) where they are at most 32,
// else by a pairwise tree; out(j, ch) = red[j * rows * C + ch] after it.
template <int V, int NQ>
__device__ __forceinline__ void block_sums(float (&q)[NQ][V], float* red,
                                           int C, int cvs, int rows,
                                           bool shuffle, int row, int c) {
  const int t = threadIdx.x, T = blockDim.x;
  int r = row;
  if (shuffle) {
    for (int off = cvs; off < 32; off *= 2)
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int i = 0; i < V; ++i)
          q[j][i] += __shfl_xor_sync(0xffffffffu, q[j][i], off);
    r = t / 32;
  }
  __syncthreads();                 // red is free
  if (!shuffle || t % 32 < cvs) {
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int i = 0; i < V; ++i) red[(j * rows + r) * C + c + i] = q[j][i];
  }
  __syncthreads();
  if (rows <= 32) {
    for (int e = t; e < NQ * C; e += T) {
      float* col = red + (e / C) * rows * C + e % C;
      float sum = col[0];
      for (int rr = 1; rr < rows; ++rr) sum += col[rr * C];
      col[0] = sum;
    }
  } else {
    const bool in = t < rows * cvs;
    const int tr = t / cvs, tc = (t % cvs) * V;
    for (int st = 1; st < rows; st *= 2) {
      if (in && tr % (2 * st) == 0 && tr + st < rows)
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int i = 0; i < V; ++i)
            red[(j * rows + tr) * C + tc + i] +=
                red[(j * rows + tr + st) * C + tc + i];
      __syncthreads();
    }
  }
  __syncthreads();
}

// dz of one element: gout where the forward's output was positive
__device__ __forceinline__ float masked(float g, float y, float scale,
                                        float shift, int relu) {
  return relu && !(fmaf(y, scale, shift) > 0.f) ? 0.f : g;
}

// f(p, y, gout) for the thread's pixels p = row, row + k, ... < npx of a
// chunk: the first ns from the staged copy, the rest from device memory.
template <int V, typename Tg, typename F>
__device__ __forceinline__ void for_pixels(const float* ys, const Tg* gs,
                                           const float* yg, const Tg* gg,
                                           long long ns, long long npx,
                                           int C, int row, int k, int c,
                                           F&& f) {
  int p = row;                       // a stage is under 2^31 bytes
#pragma unroll 2
  for (; p < ns; p += k) {
    float yv[V], gv[V];
    hg::load_vec<V>(ys + p * C + c, yv);
    hg::load_vec<V>(gs + p * C + c, gv);
    f(p, yv, gv);
  }
  for (long long pl = p; pl < npx; pl += k) {
    float yv[V], gv[V];
    hg::load_vec<V>(yg + pl * C + c, yv);
    hg::load_vec<V>(gg + pl * C + c, gv);
    f(pl, yv, gv);
  }
}

template <int V, typename Tg>
__global__ void __launch_bounds__(V == 1 ? 1024 : kThreads, 1)
gn_bwd_wave_kernel(const Args<Tg> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C, G = a.G, cpg = C / G, cvs = C / V, T = blockDim.x,
            k = T / cvs;
  const int t = threadIdx.x, row = t / cvs, c = (t % cvs) * V;
  float* red = reinterpret_cast<float*>(smem + a.stages * a.stage_bytes);
  int* flag = reinterpret_cast<int*>(red + pad16(4 * a.red_floats) / 4);
  float* csum = reinterpret_cast<float*>(flag + 4);   // (2, C)
  float* coef = csum + 2 * C;                         // (G, 2)
  float* gam = coef + 2 * C;                          // (C,)
  // block i's item of wave w: sample w spw + i / chunks, chunk i % chunks
  const int bi = blockIdx.x / a.chunks, j = blockIdx.x % a.chunks;
  const long long p0 = (long long)j * a.chunk_px;
  const long long npx =
      a.HW - p0 < a.chunk_px ? a.HW - p0 : (long long)a.chunk_px;
  const long long ns = npx < a.staged_px ? npx : a.staged_px;
  float gamma[V], beta[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    gamma[i] = a.gamma[c + i];
    beta[i] = a.beta[c + i];
  }
  for (int e = t; e < C; e += T) gam[e] = a.gamma[e];
  // the copies, by every warp but warp 0 (see arrive): 16-byte cp.async
  // where every pixel row is whole 16-byte units (vec), else element by
  // element; the statistics by 4-byte cp.async
  const int ct = t - 32, CT = T - 32;
  auto stage = [&](int w) {
    const int b = w * a.spw + bi;
    if (w < a.waves && b < a.B && ct >= 0) {
      unsigned char* buf = smem + (w % a.stages) * a.stage_bytes;
      const long long e0 = ((long long)b * a.HW + p0) * C, n = ns * C;
      float* yd = reinterpret_cast<float*>(buf);
      Tg* gd = reinterpret_cast<Tg*>(buf + a.gout_off);
      float* sd = reinterpret_cast<float*>(buf + a.stats_off);
      for (int g = ct; g < G; g += CT) {
        const long long si = ((long long)b * G + g) * a.stat_stride;
        cp_async4(sd + g, a.mean + si);
        cp_async4(sd + C + g, a.rstd + si);
      }
      if (a.vec) {
        const char* ysrc = reinterpret_cast<const char*>(a.y + e0);
        const char* gsrc = reinterpret_cast<const char*>(a.gout + e0);
        const long long uy = n * 4 / 16, ug = n * (long long)sizeof(Tg) / 16;
        for (long long u = ct; u < uy; u += CT)
          hg::cp_async16(reinterpret_cast<char*>(yd) + 16 * u, ysrc + 16 * u,
                         16);
        for (long long u = ct; u < ug; u += CT)
          hg::cp_async16(reinterpret_cast<char*>(gd) + 16 * u, gsrc + 16 * u,
                         16);
      } else {
        for (long long e = ct; e < n; e += CT) {
          yd[e] = a.y[e0 + e];
          gd[e] = a.gout[e0 + e];
        }
      }
    }
    hg::cp_async_commit();   // one group a wave, empty where idle
  };
  // wave w's item: its staged chunk (block-uniform: null where the block is
  // idle in wave w) and its place in y, gout and gpre
  struct Item {
    const float *ys, *st, *yg;
    const Tg *gs, *gg;
    long long e0;
    int b;
  };
  auto item = [&](int w) {
    Item it{};
    it.b = w * a.spw + bi;
    if (w >= a.waves || it.b >= a.B) {
      it.ys = nullptr;
      return it;
    }
    const unsigned char* buf = smem + (w % a.stages) * a.stage_bytes;
    it.ys = reinterpret_cast<const float*>(buf);
    it.gs = reinterpret_cast<const Tg*>(buf + a.gout_off);
    it.st = reinterpret_cast<const float*>(buf + a.stats_off);
    it.e0 = ((long long)it.b * a.HW + p0) * C;
    it.yg = a.y + it.e0;
    it.gg = a.gout + it.e0;
    return it;
  };
  auto constants = [&](const Item& it, float (&mean)[V], float (&rstd)[V],
                       float (&scale)[V], float (&shift)[V]) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      mean[i] = it.st[(c + i) / cpg];
      rstd[i] = it.st[C + (c + i) / cpg];
      scale[i] = rstd[i] * gamma[i];
      // rounded twice, not fused: the forward's shift (gn_apply_kernel)
      shift[i] = __fsub_rn(beta[i], __fmul_rn(mean[i], scale[i]));
    }
  };
  // 1. the chunk's (sum dz yhat, sum dz) per channel, published
  auto reduce = [&](int w) {
    const Item it = item(w);
    if (!it.ys) return;
    float mean[V], rstd[V], scale[V], shift[V], q[2][V];
    constants(it, mean, rstd, scale, shift);
#pragma unroll
    for (int i = 0; i < V; ++i) q[0][i] = q[1][i] = 0.f;
    for_pixels<V>(it.ys, it.gs, it.yg, it.gg, ns, npx, C, row, k, c,
                  [&](long long, const float(&yv)[V], const float(&gv)[V]) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = masked(gv[i], yv[i], scale[i], shift[i], a.relu);
        q[1][i] += d;
        q[0][i] = fmaf(d, (yv[i] - mean[i]) * rstd[i], q[0][i]);
      }
    });
    block_sums<V, 2>(q, red, C, cvs, a.rows, a.shuffle, row, c);
    if (t < 32) {
      float* part = a.partial + ((long long)it.b * a.chunks + j) * 2 * C;
      for (int e = t; e < 2 * C; e += 32)
        part[e] = red[(e / C) * a.rows * C + e % C];
      __syncwarp();
      arrive(a.arrive + it.b);
    }
  };
  // 2. once every chunk has arrived, each block folds the sample's partials
  //    in chunk order (the same sums in every block) and its per-group
  //    (rstd A / n, f rstd Bs / n); 3. gpre from the staged copy, summed
  //    into the block's running sums
  float bs[1][V];
#pragma unroll
  for (int i = 0; i < V; ++i) bs[0][i] = 0.f;
  auto fold_apply = [&](int w) {
    const Item it = item(w);
    if (!it.ys) return;
    wait_for(a.arrive + it.b, a.chunks);
    fold_rows(a.partial + (long long)it.b * a.chunks * 2 * C, a.chunks, 2 * C,
              csum, red);
    if (j == 0)
      for (int e = t; e < 2 * C; e += T)
        a.sums[(long long)it.b * 2 * C + e] = csum[e];
    const float rstd_eps = rsqrtf(a.eps);   // rstd where the variance sat at 0
    for (int g = t; g < G; g += T) {
      float sa = 0.f, sb = 0.f;
      for (int cc = g * cpg; cc < (g + 1) * cpg; ++cc) {
        sa = fmaf(gam[cc], csum[C + cc], sa);
        sb = fmaf(gam[cc], csum[cc], sb);
      }
      const float r = it.st[C + g];
      coef[2 * g] = r * sa / a.count;
      coef[2 * g + 1] = (r < rstd_eps ? 1.f : 0.f) * r * sb / a.count;
    }
    __syncthreads();
    float mean[V], rstd[V], scale[V], shift[V], a1[V], a2[V];
    constants(it, mean, rstd, scale, shift);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      a1[i] = coef[2 * ((c + i) / cpg)];
      a2[i] = coef[2 * ((c + i) / cpg) + 1];
    }
    Tg* out = a.gpre + it.e0 + c;
    for_pixels<V>(it.ys, it.gs, it.yg, it.gg, ns, npx, C, row, k, c,
                  [&](long long p, const float(&yv)[V], const float(&gv)[V]) {
      float gp[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = masked(gv[i], yv[i], scale[i], shift[i], a.relu);
        const float yh = (yv[i] - mean[i]) * rstd[i];
        gp[i] = fmaf(scale[i], d, -fmaf(a2[i], yh, a1[i]));
        bs[0][i] += gp[i];
      }
      hg::store_vec<V>(out + p * C, gp);
    });
    __syncthreads();                           // the stage is free
  };
  // two stages: the next wave's chunk copies while this one is reduced,
  // folded and applied
  if (a.stages == 2) stage(0);
  for (int w = 0; w < a.waves; ++w) {
    if (a.stages == 2) {
      stage(w + 1);
      hg::cp_async_wait<1>();
    } else {
      stage(w);
      hg::cp_async_wait<0>();
    }
    __syncthreads();
    reduce(w);
    fold_apply(w);
  }
  // 4. after its last wave a block sums its items' gpre per channel; the
  //    last block to finish folds the samples' dgamma and dbeta and the
  //    blocks' dbias, in order
  block_sums<V, 1>(bs, red, C, cvs, a.rows, a.shuffle, row, c);
  for (int e = t; e < C; e += T)
    a.bpart[(long long)blockIdx.x * C + e] = red[e];
  __syncthreads();
  if (t == 0) {
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n"
                 : "=r"(old) : "l"(a.done), "r"(1u) : "memory");
    *flag = old == gridDim.x - 1;
  }
  __syncthreads();
  if (*flag) {
    fold_rows(a.sums, a.B, 2 * C, a.grads, red);
    fold_rows(a.bpart, gridDim.x, C, a.grads + 2 * C, red);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The shared bytes gn_bwd_wave_kernel<V, Tg> was last allowed.
template <int V, typename Tg>
size_t& smem_allowed() {
  static size_t bytes = 0;
  return bytes;
}

// One cooperative launch of `grid` blocks, or -2 where they cannot all be
// resident.  The kernel's shared-memory attribute is raised only past what
// an earlier call set (smem_set), so a call captured in a CUDA graph after
// an eager one at its shapes makes no attribute call.
template <typename K>
int launch_coop(K kernel, void** args, int grid, int threads, size_t smem,
                size_t& smem_set, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (!coop || (long long)per_sm * sms < grid) return -2;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(grid), dim3(threads), args, smem,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// out: the current device's SMs, the dynamic shared memory a block may
// opt in to, and whether it takes cooperative launches (the planner's
// inputs).  Returns a cudaError_t.
extern "C" int hg_gn_backward_device(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(out + 1, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaDeviceGetAttribute(out + 2, cudaDevAttrCooperativeLaunch, dev);
  return (int)cudaGetLastError();
}

// The backward of act(GroupNorm(y)), C <= 2048 (above 1024 a multiple of 4
// with y, gout and gpre 16-byte aligned: a thread a vector of 4 channels).
// y: float32 (B, HW, C) NHWC, the
// layer's pre-activation (bias included); gout and gpre: (B, HW, C) of
// `dtype` (0 = float32, 1 = bfloat16); mean, rstd: float32, (sample, group)
// at ((b G + g) stat_stride); gamma, beta: float32 (C,); plan: V, threads,
// chunk_px, staged_px, chunks, samples a wave, stages, shared bytes
// (conv_stack.py::gn_backward_plan); scratch: n_scratch 4-byte words,
// B x chunks x 2C + 2 B C + grid x C floats, then B + 1 counters (cleared
// here); grads:
// float32 (3, C) = dgamma, dbeta, dbias.  Returns the first non-zero CUDA
// error, -1 for arguments or a plan it does not take, -2 where the device
// cannot run the launch.
extern "C" int hg_gn_relu_backward(
    const void* y, const void* gout, const void* mean, const void* rstd,
    int stat_stride, const void* gamma, const void* beta, void* scratch,
    long long n_scratch, void* gpre, void* grads, int dtype, int B,
    long long HW, int C, int G, int relu, float eps, const int* plan,
    void* stream) {
  if (B < 1 || HW < 1 || C < 1 || C > 2048 || G < 1 || C % G ||
      stat_stride < 1 || (dtype != 0 && dtype != 1) || !y || !gout ||
      !mean || !rstd || !gamma || !beta || !scratch || !gpre || !grads ||
      !plan)
    return -1;
  const int gb = dtype == 0 ? 4 : 2;
  const bool aligned = aligned16(y) && aligned16(gout) && aligned16(gpre);
  const Layout l = layout(C, aligned);
  if (l.threads > 1024) return -1;   // C > 1024 needs vectors of 4
  const int chunk_px = plan[2], staged_px = plan[3], chunks = plan[4],
            spw = plan[5], stages = plan[6];
  if (plan[0] != l.V || plan[1] != l.threads || chunk_px < 1 ||
      (HW + chunk_px - 1) / chunk_px != chunks || staged_px < 1 ||
      staged_px > chunk_px || spw < 1 || spw > B ||
      (long long)spw * chunks > 65535 || (stages != 1 && stages != 2))
    return -1;
  const long long smem = smem_bytes(C, gb, l, staged_px, stages);
  if (plan[7] != smem) return -1;
  const long long chunked = (long long)B * chunks * C;
  const long long words =
      2 * chunked + 2LL * B * C + (long long)spw * chunks * C;
  if (n_scratch != words + B + 1) return -1;
  float* f = static_cast<float*>(scratch);
  unsigned* counters = reinterpret_cast<unsigned*>(f + words);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counters, 0, (B + 1LL) * 4, s);
  if (err != cudaSuccess) return (int)err;
  auto run = [&](auto tg) {
    using Tg = decltype(tg);
    Args<Tg> a;
    a.y = static_cast<const float*>(y);
    a.gout = static_cast<const Tg*>(gout);
    a.mean = static_cast<const float*>(mean);
    a.rstd = static_cast<const float*>(rstd);
    a.gamma = static_cast<const float*>(gamma);
    a.beta = static_cast<const float*>(beta);
    a.gpre = static_cast<Tg*>(gpre);
    a.grads = static_cast<float*>(grads);
    a.partial = f;
    a.sums = f + 2 * chunked;
    a.bpart = a.sums + 2LL * B * C;
    a.arrive = counters;
    a.done = counters + B;
    a.HW = HW;
    a.stage_bytes = stage_bytes(staged_px, C, gb);
    a.gout_off = pad16((long long)staged_px * C * 4);
    a.stats_off = a.gout_off + pad16((long long)staged_px * C * gb);
    a.red_floats = red_floats(C, l);
    a.stat_stride = stat_stride;
    a.B = B, a.C = C, a.G = G, a.relu = relu;
    a.chunk_px = chunk_px, a.staged_px = staged_px, a.chunks = chunks;
    a.spw = spw, a.waves = (B + spw - 1) / spw, a.stages = stages;
    a.vec = aligned && (C * gb) % 16 == 0 && (C * 4) % 16 == 0;
    a.rows = l.rows, a.shuffle = l.shuffle;
    a.count = (float)(HW * (C / G));
    a.eps = eps;
    void* args[] = {&a};
    return hg::dispatch_v(l.V, [&](auto v) {
      constexpr int V = decltype(v)::value;
      return launch_coop(gn_bwd_wave_kernel<V, Tg>, args, spw * chunks,
                         l.threads, (size_t)smem, smem_allowed<V, Tg>(), s);
    });
  };
  return dtype == 0 ? run(float{}) : run(__nv_bfloat16{});
}
