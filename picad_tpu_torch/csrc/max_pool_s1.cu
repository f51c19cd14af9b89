// Stride-1 zero-padded max pool along one axis, forward and backward, for
// Hopper (sm_90a).
//
// No Pallas kernel stands behind these.  They replace the JAX package's
// hand-written separable pool, `_max_pool_axis` (a jax.custom_vjp,
// picad_tpu/ops/convops.py:208-268), which XLA fuses on the TPU, and the
// port's plain chain of it (ops/convops.py: max_pool_axis_plain and
// max_pool_axis_bwd_plain: pad + unfold + amax forward, and for every tap
// two torch.full + torch.cat shifts, a compare, a cast, a multiply and an
// add backward).  One stage pools the contiguous tensor viewed as (outer,
// L, inner) along L with window k, stride 1 and TF-SAME zero pads lo = (k
// - 1) / 2 below and k - 1 - lo above:
//
//   forward   y[j]  = max of x[j - lo + t], t = 0 .. k - 1, zeros outside
//                     [0, L), combined in t order as torch's amax combines
//                     (a NaN kept once met, else the later of equal values),
//                     so NaN and the bits of the kept value are torch's;
//   backward  dx[i] = sum over t = 0 .. k - 1 with j = i - t + lo in [0, L)
//                     of 1[x[i] == y[j]] * g[j], in f32 from +0 in t order,
//                     each term a multiply of the 0/1 mask by g (0 * inf is
//                     NaN, as in the plain chain), rounded to x's type.
//
// The plain chain adds exactly +0 for a tap whose window lies outside [0,
// L), so skipping it changes no bit: the results are the plain chain's bit
// for bit in f32 and bf16.
//
// Bound on an H100 SXM (3.35 TB/s): a forward stage reads x and writes y,
// a backward stage reads x, y and g and writes dx, with a few operations
// an element; at the train step's seven pools (16 x 192-528 channels x
// 1-2 x 28 x 28, bf16) that is 0.35 ms for the 16 forward and 16 backward
// stages of a step.  So bytes bound them, and the design keeps loads wide
// and the arithmetic per element small:
//   - one launch a stage, one thread a vector of N elements (16 bytes
//     where the row allows it, else 8, 4 or 2), no shared memory;
//   - pooled axis not innermost (inner > 1): the vector runs along inner,
//     and each tap is one aligned vector load of another row (`_rows`);
//   - pooled axis innermost (inner == 1, the W stage) with the model's
//     window k = 3 fixed at compile time: the vector runs along L, and the
//     thread loads its N elements as one vector plus one element on each
//     side (`_line`); any other window runs the `_rows` kernel with N = 1.
// PERF.md has its times beside the bound and the plain chain's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int NTHREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as torch's .to(bfloat16) on the card
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() { return __ushort_as_bfloat16(0); }

// torch's max with NaN (MaxNanFunctor): a if a is NaN or greater, else b
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  const float fa = to_f(a), fb = to_f(b);
  return (fa != fa || fa > fb) ? a : b;
}

// acc + 1[x == y] * g, the plain chain's two f32 operations, neither fused
__device__ __forceinline__ float add_tap(float acc, float x, float y, float g) {
  return __fadd_rn(acc, __fmul_rn(x == y ? 1.f : 0.f, g));
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Vec<T, N> load(const T* p) {
  return *reinterpret_cast<const Vec<T, N>*>(p);
}

template <typename T, int N>
__device__ __forceinline__ Vec<T, N> zeros() {
  Vec<T, N> r;
#pragma unroll
  for (int e = 0; e < N; ++e) r.v[e] = zero_of<T>();
  return r;
}

// The pooled axis strided by inner: a thread owns x[o, j, iv*N .. iv*N+N),
// vectors indexed q = (o * L + j) * (inner / N) + iv.
template <typename T, int N>
__global__ void __launch_bounds__(NTHREADS)
picad_axis_pool_fwd_rows(const T* __restrict__ x, T* __restrict__ y, int L, int inner, int k,
                         int lo, int nvec) {
  const int q = blockIdx.x * NTHREADS + threadIdx.x;
  if (q >= nvec) return;
  const int ivn = inner / N, r = q / ivn, j = r % L;
  const int base = (r - j) * inner + (q - r * ivn) * N;  // row 0 of this (o, iv)
  Vec<T, N> m;
  for (int t = 0; t < k; ++t) {
    const int jj = j - lo + t;
    const Vec<T, N> v = (unsigned)jj < (unsigned)L ? load<T, N>(x + base + jj * inner) : zeros<T, N>();
    if (t == 0) {
      m = v;
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) m.v[e] = max_nan(m.v[e], v.v[e]);
    }
  }
  *reinterpret_cast<Vec<T, N>*>(y + base + j * inner) = m;
}

template <typename T, int N>
__global__ void __launch_bounds__(NTHREADS)
picad_axis_pool_bwd_rows(const T* __restrict__ x, const T* __restrict__ y,
                         const T* __restrict__ g, T* __restrict__ dx, int L, int inner, int k,
                         int lo, int nvec) {
  const int q = blockIdx.x * NTHREADS + threadIdx.x;
  if (q >= nvec) return;
  const int ivn = inner / N, r = q / ivn, j = r % L;
  const int base = (r - j) * inner + (q - r * ivn) * N;
  const Vec<T, N> xv = load<T, N>(x + base + j * inner);
  float acc[N];
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = 0.f;
  for (int t = 0; t < k; ++t) {
    const int jj = j - t + lo;  // the window that holds x[j] at tap t
    if ((unsigned)jj >= (unsigned)L) continue;
    const Vec<T, N> yv = load<T, N>(y + base + jj * inner), gv = load<T, N>(g + base + jj * inner);
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] = add_tap(acc[e], to_f(xv.v[e]), to_f(yv.v[e]), to_f(gv.v[e]));
  }
  Vec<T, N> out;
#pragma unroll
  for (int e = 0; e < N; ++e) out.v[e] = from_f<T>(acc[e]);
  *reinterpret_cast<Vec<T, N>*>(dx + base + j * inner) = out;
}

// The pooled axis innermost, window K (lo = (K - 1) / 2): a thread owns
// x[r, jv*N .. jv*N+N) of row r, vectors indexed q = r * (L / N) + jv, and
// reads w[u] = row[j0 - A + u], u in [0, N + K - 1), as its vector at u = A
// and single elements around it, zero outside [0, L).
template <typename T, int N, int K, int A>
__device__ __forceinline__ void line_window(const T* __restrict__ row, int j0, int L, T (&w)[N + K - 1]) {
  const Vec<T, N> mid = load<T, N>(row + j0);
#pragma unroll
  for (int u = 0; u < N + K - 1; ++u) {
    const int jj = j0 - A + u;
    if (u >= A && u < A + N)
      w[u] = mid.v[u - A];
    else
      w[u] = (unsigned)jj < (unsigned)L ? row[jj] : zero_of<T>();
  }
}

template <typename T, int N, int K>
__global__ void __launch_bounds__(NTHREADS)
picad_axis_pool_fwd_line(const T* __restrict__ x, T* __restrict__ y, int L, int nvec) {
  constexpr int LO = (K - 1) / 2;
  const int q = blockIdx.x * NTHREADS + threadIdx.x;
  if (q >= nvec) return;
  const int jvn = L / N, r = q / jvn, j0 = (q - r * jvn) * N;
  T w[N + K - 1];  // w[u] = x[j0 - LO + u]
  line_window<T, N, K, LO>(x + r * L, j0, L, w);
  Vec<T, N> m;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    T v = w[e];
#pragma unroll
    for (int t = 1; t < K; ++t) v = max_nan(v, w[e + t]);
    m.v[e] = v;
  }
  *reinterpret_cast<Vec<T, N>*>(y + r * L + j0) = m;
}

template <typename T, int N, int K>
__global__ void __launch_bounds__(NTHREADS)
picad_axis_pool_bwd_line(const T* __restrict__ x, const T* __restrict__ y,
                         const T* __restrict__ g, T* __restrict__ dx, int L, int nvec) {
  constexpr int LO = (K - 1) / 2, HI = K - 1 - LO;
  const int q = blockIdx.x * NTHREADS + threadIdx.x;
  if (q >= nvec) return;
  const int jvn = L / N, r = q / jvn, j0 = (q - r * jvn) * N;
  const Vec<T, N> xv = load<T, N>(x + r * L + j0);
  T yw[N + K - 1], gw[N + K - 1];  // [u] = at j0 - HI + u: window j = i - t + LO is u = e - t + K - 1
  line_window<T, N, K, HI>(y + r * L, j0, L, yw);
  line_window<T, N, K, HI>(g + r * L, j0, L, gw);
  Vec<T, N> out;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const int u = e - t + K - 1;
      if ((unsigned)(j0 - HI + u) < (unsigned)L)
        acc = add_tap(acc, to_f(xv.v[e]), to_f(yw[u]), to_f(gw[u]));
    }
    out.v[e] = from_f<T>(acc);
  }
  *reinterpret_cast<Vec<T, N>*>(dx + r * L + j0) = out;
}

// the largest of 16, 8, 4, 2, 1 bytes that divides every value
int vec_bytes(std::initializer_list<long long> vals) {
  int vb = 16;
  for (long long v : vals)
    while (v % vb != 0) vb >>= 1;
  return vb;
}

int blocks(int nvec) { return (nvec + NTHREADS - 1) / NTHREADS; }

constexpr int LINE_K = 3;  // the model's window (models/i3d.py:145)

// ptrs: x, y[, g, dx]; one launch, its CUDA error returned
template <typename T, bool BWD>
int run(const void* const* ptrs, int n_ptrs, int outer, int L, int inner, int k, int lo,
        cudaStream_t s) {
  constexpr int ES = (int)sizeof(T);
  const long long total = (long long)outer * L * inner;
  long long addr = 0;
  for (int i = 0; i < n_ptrs; ++i) addr |= (long long)(uintptr_t)ptrs[i];
  const T* x = static_cast<const T*>(ptrs[0]);
  if (inner == 1 && k == LINE_K) {
    const int vb = vec_bytes({addr, (long long)L * ES});
    const int n = vb / ES, nvec = (int)(total / n);
#define PICAD_LINE(NV)                                                                         \
  if (n == NV) {                                                                               \
    if constexpr (BWD)                                                                         \
      picad_axis_pool_bwd_line<T, NV, LINE_K><<<blocks(nvec), NTHREADS, 0, s>>>(               \
          x, static_cast<const T*>(ptrs[1]), static_cast<const T*>(ptrs[2]),                   \
          static_cast<T*>(const_cast<void*>(ptrs[3])), L, nvec);                               \
    else                                                                                       \
      picad_axis_pool_fwd_line<T, NV, LINE_K><<<blocks(nvec), NTHREADS, 0, s>>>(               \
          x, static_cast<T*>(const_cast<void*>(ptrs[1])), L, nvec);                            \
    return (int)cudaGetLastError();                                                            \
  }
    PICAD_LINE(8)
    PICAD_LINE(4)
    PICAD_LINE(2)
#undef PICAD_LINE
  }
  const int vb = vec_bytes({addr, (long long)inner * ES});
  const int n = vb < ES ? 1 : vb / ES, nvec = (int)(total / n);
#define PICAD_ROWS(NV)                                                                         \
  if (n == NV) {                                                                               \
    if constexpr (BWD)                                                                         \
      picad_axis_pool_bwd_rows<T, NV><<<blocks(nvec), NTHREADS, 0, s>>>(                       \
          x, static_cast<const T*>(ptrs[1]), static_cast<const T*>(ptrs[2]),                   \
          static_cast<T*>(const_cast<void*>(ptrs[3])), L, inner, k, lo, nvec);                 \
    else                                                                                       \
      picad_axis_pool_fwd_rows<T, NV><<<blocks(nvec), NTHREADS, 0, s>>>(                       \
          x, static_cast<T*>(const_cast<void*>(ptrs[1])), L, inner, k, lo, nvec);              \
    return (int)cudaGetLastError();                                                            \
  }
  PICAD_ROWS(8)
  PICAD_ROWS(4)
  PICAD_ROWS(2)
  PICAD_ROWS(1)
#undef PICAD_ROWS
  return (int)cudaErrorInvalidValue;
}

int check(int outer, int L, int inner, int k, int lo) {
  if (outer < 0 || L < 0 || inner < 0 || k < 1 || lo != (k - 1) / 2 ||
      (long long)outer * L * inner > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// x and y contiguous (outer, L, inner), of one type: f32 (bf16 = 0) or
// bf16 (bf16 = 1); y = the stride-1 max pool of x along L, window k, zero
// pads lo = (k - 1) / 2 below and k - 1 - lo above.  One launch; returns
// its CUDA error (0 on success).
extern "C" int picad_max_pool_axis_fwd(const void* x, void* y, int outer, int L, int inner, int k,
                                       int lo, int bf16, void* stream) {
  if (int err = check(outer, L, inner, k, lo)) return err;
  if ((long long)outer * L * inner == 0) return 0;
  const void* ptrs[2] = {x, y};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? run<__nv_bfloat16, false>(ptrs, 2, outer, L, inner, k, lo, s)
              : run<float, false>(ptrs, 2, outer, L, inner, k, lo, s);
}

// x, y, g and dx contiguous (outer, L, inner), of one type; dx = the
// gradient of that pool at x given g, the gradient of y.  One launch.
extern "C" int picad_max_pool_axis_bwd(const void* x, const void* y, const void* g, void* dx,
                                       int outer, int L, int inner, int k, int lo, int bf16,
                                       void* stream) {
  if (int err = check(outer, L, inner, k, lo)) return err;
  if ((long long)outer * L * inner == 0) return 0;
  const void* ptrs[4] = {x, y, g, dx};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? run<__nv_bfloat16, true>(ptrs, 4, outer, L, inner, k, lo, s)
              : run<float, true>(ptrs, 4, outer, L, inner, k, lo, s);
}
