// hex_max_pool: the strided NaN-aware max-pool of the brick lattice on
// NHWC tensors, and its backward.
//
// Replaces no TPU kernel: hygrid_tpu's pools are XLA
// (hygrid_tpu/nn/functional.py::_hex_window_reduce), and the port ran them
// as plain PyTorch (nn/functional.py::_window_reduce: a gather of every
// window, isnan, where and two amax passes, whose autograd is three nodes).
//
// Window (gi, gj) covers rows sh*gi + [0, kh) and columns
// (gi % 2)*(sw/2) + sw*gj + [0, kw) of (B, H, W, C), with kh <= min(sh, 2)
// and kw <= min(sw, 2): windows of at most 2 x 2 cells that do not
// overlap.  A NaN counts as -inf.  The reduction is _window_reduce's two
// stages, over the window's rows first (m_j = max_i x[i, j]), then over its
// columns (M = max_j m_j).
//
// The forward writes M, NHWC-contiguous, and where a gradient is wanted a
// uint8 tie mask beside each output element: bit 2i + j set where cell
// (i, j), NaN counted as -inf, equals M; bit 4 + 2i + j set where it is NaN.
// The backward reads the output gradient g and the mask and writes every
// input cell's gradient once: 0 for a cell no window covers or a NaN cell,
// else torch's amax backward of the two stages, each step rounded to the
// element type as autograd rounds it,
//
//   gJ = tied_j ? g / cJ : g * 0        cJ = columns of the window tied at M
//   dx = tie_ij ? gJ / cI_j : gJ * 0    cI_j = cells of column j tied at M
//
// then 0 + dx (the plain path's accumulation into zeros, which turns -0
// into +0).  Every count is 1 or 2, so each share is exact and the result
// is the plain path's bit for bit (a g * 0 is NaN where g is not finite,
// as there).
//
// What bounds it: memory.  A handful of compares a value; the forward reads
// each window's cells once and writes the output (and the mask, a quarter
// of the output's bytes in float32), the backward reads the output
// gradient and the mask and writes the input gradient.  Design: a thread
// takes 16 bytes of channels (4 float32 or 8 bf16 values) of one output
// cell, so a warp's loads and stores are consecutive 16-byte units along C;
// channel counts that do not split into 16-byte units, or unaligned
// tensors, take one element a thread.  A block covers part of one row of
// windows, so the batch index and window row are uniform in it.  The
// backward's thread writes the whole stride block of its window, the cells
// no window covers included, so that the division of a thread's index into
// cell and channel, and the gradient's and mask's loads, are made once a
// window rather than once an input cell.
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <int V>
struct alignas(V) MaskPack {
  uint8_t b[V];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    max_pool_kernel(const T* __restrict__ x, T* __restrict__ out,
                    uint8_t* __restrict__ mask, int H, int W, int C, int hn,
                    int wn, int kh, int kw, int sh, int sw, int tiles) {
  const int nv = C / V;
  const unsigned row = blockIdx.x / tiles;  // b * hn + gi
  const int t = (blockIdx.x - row * tiles) * kThreads + threadIdx.x;
  if (t >= wn * nv) return;
  const int gj = t / nv, cv = t - gj * nv;
  const int gi = row % hn;
  const long long b = row / hn;
  const int c0 = (gi & 1) * (sw / 2) + sw * gj;
  const T* src = x + ((b * H + (long long)sh * gi) * W + c0) * C + cv * V;
  float v[2][2][V];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (i < kh && j < kw) {
        const Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(
            src + ((long long)i * W + j) * C);
#pragma unroll
        for (int l = 0; l < V; ++l) v[i][j][l] = to_f(p.v[l]);
      }
    }
  Pack<T, V> o;
  MaskPack<V> mk;
#pragma unroll
  for (int l = 0; l < V; ++l) {
    unsigned nan_bits = 0;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (i < kh && j < kw && v[i][j][l] != v[i][j][l]) {
          v[i][j][l] = -INFINITY;
          nan_bits |= 1u << (4 + 2 * i + j);
        }
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j < kw) {
        const float mj = kh > 1 ? fmaxf(v[0][j][l], v[1][j][l]) : v[0][j][l];
        m = j == 0 ? mj : fmaxf(m, mj);
      }
    }
    from_f(m, &o.v[l]);
    unsigned tie_bits = 0;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (i < kh && j < kw && v[i][j][l] == m) tie_bits |= 1u << (2 * i + j);
    mk.b[l] = static_cast<uint8_t>(tie_bits | nan_bits);
  }
  const long long at = ((long long)row * wn + gj) * C + cv * V;
  *reinterpret_cast<Pack<T, V>*>(out + at) = o;
  if (mask != nullptr) *reinterpret_cast<MaskPack<V>*>(mask + at) = mk;
}

template <typename T, int V>
__device__ __forceinline__ void store_zeros(T* p) {
  Pack<T, V> o;
#pragma unroll
  for (int l = 0; l < V; ++l) from_f(0.f, &o.v[l]);
  *reinterpret_cast<Pack<T, V>*>(p) = o;
}

// A thread a window and 16 bytes of channels: it reads the window's output
// gradient and mask once and writes every input cell of the window's stride
// block, the window's cells with their shares and the rest 0, so that each
// input cell is written once: window row gi owns rows [sh*gi, sh*gi + sh)
// (the last one every row to H), window (gi, gj) columns [c0, c0 + sw) (the
// first from column 0, the last every column to W).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    max_pool_backward_kernel(const T* __restrict__ gout,
                             const uint8_t* __restrict__ mask,
                             T* __restrict__ dx, int H, int W, int C, int hn,
                             int wn, int kh, int kw, int sh, int sw,
                             int tiles) {
  const int nv = C / V;
  const unsigned row = blockIdx.x / tiles;  // b * hn + gi
  const int t = (blockIdx.x - row * tiles) * kThreads + threadIdx.x;
  if (t >= wn * nv) return;
  const int gj = t / nv, cv = t - gj * nv;
  const int gi = row % hn;
  const long long b = row / hn;
  const int r0 = sh * gi, c0 = (gi & 1) * (sw / 2) + sw * gj;
  const long long at = ((long long)row * wn + gj) * C + cv * V;
  const Pack<T, V> g = *reinterpret_cast<const Pack<T, V>*>(gout + at);
  const MaskPack<V> mk = *reinterpret_cast<const MaskPack<V>*>(mask + at);
  T* img = dx + b * H * W * (long long)C + cv * V;
  // a tied cell's share is g halved once for each stage with two ties, each
  // halving rounded (g, s1 or s2); any other cell gets 0 + g * 0 (z: 0, or
  // NaN where g is not finite), a NaN cell 0
  T s1[V], s2[V], z[V], zero;
  bool two_cols[V];
  from_f(0.f, &zero);
#pragma unroll
  for (int l = 0; l < V; ++l) {
    const float gv = to_f(g.v[l]);
    from_f(gv * 0.5f, &s1[l]);
    from_f(to_f(s1[l]) * 0.5f, &s2[l]);
    from_f(0.f + gv * 0.f, &z[l]);
    two_cols[l] = (mk.b[l] & 5u) && (mk.b[l] & 10u);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (i >= kh || j >= kw) continue;
      Pack<T, V> o;
#pragma unroll
      for (int l = 0; l < V; ++l) {
        const unsigned bits = mk.b[l];
        const bool two_rows = ((bits >> j) & 5u) == 5u;  // column j's ties
        const T tied = two_rows ? (two_cols[l] ? s2[l] : s1[l])
                                : (two_cols[l] ? s1[l] : g.v[l]);
        o.v[l] = (bits >> (4 + 2 * i + j)) & 1u ? zero
                 : (bits >> (2 * i + j)) & 1u   ? tied
                                                : z[l];
      }
      *reinterpret_cast<Pack<T, V>*>(
          img + ((long long)(r0 + i) * W + c0 + j) * C) = o;
    }
  const int r_end = gi == hn - 1 ? H : r0 + sh;
  const int c_begin = gj == 0 ? 0 : c0;
  const int c_end = gj == wn - 1 ? W : c0 + sw;
  for (int r = r0; r < r_end; ++r)
    for (int c = c_begin; c < c_end; ++c)
      if (r - r0 >= kh || c < c0 || c - c0 >= kw)
        store_zeros<T, V>(img + ((long long)r * W + c) * C);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// (rows of the grid, threads a row) -> blocks, or 0 where the grid is too
// large for one dimension
long long blocks(long long rows, long long per_row, int* tiles) {
  *tiles = static_cast<int>((per_row + kThreads - 1) / kThreads);
  const long long n = rows * *tiles;
  return n <= 2147483647LL ? n : 0;
}

// whether both entry points take the geometry
bool geometry_ok(long long B, int H, int W, int C, int hn, int wn, int kh,
                 int kw, int sh, int sw) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || hn < 1 || wn < 1) return false;
  if (kh < 1 || kh > 2 || kw < 1 || kw > 2 || kh > sh || kw > sw) return false;
  if ((long long)sh * (hn - 1) + kh > H) return false;
  const long long last = (hn > 1 ? sw / 2 : 0) + (long long)sw * (wn - 1) + kw;
  if (last > W || (long long)W * C > 2147483647LL) return false;
  return B * hn <= 4294967295LL;
}

template <typename T>
int launch_forward(const void* x, void* out, void* mask, long long B, int H,
                   int W, int C, int hn, int wn, int kh, int kw, int sh,
                   int sw, cudaStream_t s) {
  constexpr int V16 = 16 / sizeof(T);
  const bool vec = C % V16 == 0 && aligned16(x) && aligned16(out) &&
                   (mask == nullptr ||
                    (reinterpret_cast<uintptr_t>(mask) & (V16 - 1)) == 0);
  const int nv = vec ? C / V16 : C;
  int tiles;
  const long long n = blocks(B * hn, (long long)wn * nv, &tiles);
  if (n == 0) return -1;
  auto xs = static_cast<const T*>(x);
  auto os = static_cast<T*>(out);
  auto ms = static_cast<uint8_t*>(mask);
  if (vec)
    max_pool_kernel<T, V16><<<static_cast<unsigned>(n), kThreads, 0, s>>>(
        xs, os, ms, H, W, C, hn, wn, kh, kw, sh, sw, tiles);
  else
    max_pool_kernel<T, 1><<<static_cast<unsigned>(n), kThreads, 0, s>>>(
        xs, os, ms, H, W, C, hn, wn, kh, kw, sh, sw, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_backward(const void* gout, const void* mask, void* dx, long long B,
                    int H, int W, int C, int hn, int wn, int kh, int kw,
                    int sh, int sw, cudaStream_t s) {
  constexpr int V16 = 16 / sizeof(T);
  const bool vec = C % V16 == 0 && aligned16(gout) && aligned16(dx) &&
                   (reinterpret_cast<uintptr_t>(mask) & (V16 - 1)) == 0;
  const int nv = vec ? C / V16 : C;
  int tiles;
  const long long n = blocks(B * hn, (long long)wn * nv, &tiles);
  if (n == 0) return -1;
  auto gs = static_cast<const T*>(gout);
  auto ms = static_cast<const uint8_t*>(mask);
  auto ds = static_cast<T*>(dx);
  if (vec)
    max_pool_backward_kernel<T, V16>
        <<<static_cast<unsigned>(n), kThreads, 0, s>>>(
            gs, ms, ds, H, W, C, hn, wn, kh, kw, sh, sw, tiles);
  else
    max_pool_backward_kernel<T, 1>
        <<<static_cast<unsigned>(n), kThreads, 0, s>>>(
            gs, ms, ds, H, W, C, hn, wn, kh, kw, sh, sw, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, H, W, C) -> out (B, hn, wn, C), both contiguous, and where mask is
// not null the (B, hn, wn, C) uint8 tie mask.  dtype 0 float32, 1 bf16.
extern "C" int hg_hex_max_pool(const void* x, void* out, void* mask,
                               int dtype, long long B, int H, int W, int C,
                               int hn, int wn, int kh, int kw, int sh, int sw,
                               void* stream) {
  if (x == nullptr || out == nullptr ||
      !geometry_ok(B, H, W, C, hn, wn, kh, kw, sh, sw))
    return -1;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_forward<float>(x, out, mask, B, H, W, C, hn, wn, kh, kw, sh,
                                 sw, s);
  if (dtype == 1)
    return launch_forward<__nv_bfloat16>(x, out, mask, B, H, W, C, hn, wn,
                                         kh, kw, sh, sw, s);
  return -1;
}

// gout (B, hn, wn, C) and the forward's mask -> dx (B, H, W, C), every
// element written.
extern "C" int hg_hex_max_pool_backward(const void* gout, const void* mask,
                                        void* dx, int dtype, long long B,
                                        int H, int W, int C, int hn, int wn,
                                        int kh, int kw, int sh, int sw,
                                        void* stream) {
  if (gout == nullptr || mask == nullptr || dx == nullptr ||
      !geometry_ok(B, H, W, C, hn, wn, kh, kw, sh, sw))
    return -1;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_backward<float>(gout, mask, dx, B, H, W, C, hn, wn, kh, kw,
                                  sh, sw, s);
  if (dtype == 1)
    return launch_backward<__nv_bfloat16>(gout, mask, dx, B, H, W, C, hn, wn,
                                          kh, kw, sh, sw, s);
  return -1;
}
