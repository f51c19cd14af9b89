// Backward of the strided, zero-padded max pools, for Hopper (sm_90a).
//
// No Pallas kernel stands behind this one.  The JAX package leaves the
// strided pools' backward to XLA's select-and-scatter
// (picad_tpu/ops/convops.py:198, lax.reduce_window under jax.grad), which
// gives each window's gradient to its FIRST maximum in scan order (the
// `ge` select keeps the earlier tap) and is deterministic.  torch's own
// backward of F.max_pool3d on the card (max_pool3d_with_indices_backward)
// scatters the windows' gradients with atomics, in no fixed order, and
// has no deterministic form; this kernel replaces it.
//
// Gather form, in f32, cast to x's type:
//
//   dx[p] = sum over windows j covering p, in order of p's offset in j
//           (row-major over the window, i.e. j descending), of
//           g[j] if p is window j's first tap (row-major) equal to y[j].
//
// The "first maximum" is recomputed from xp and y (the forward's output):
// no indices are kept from the forward, and there are no atomics, so the
// result is the same from run to run.  The plain version (ops/convops.py:
// max_pool_bwd_plain) sums in the same order, so the two agree bit for
// bit in f32.  Pads are zeros that count in the windows (the reference
// zero-pads, then pools): a pad tap can be the first maximum, and its
// gradient is dropped, as the pad's transpose drops it in JAX.
//
// Bound on an H100 SXM at the first pool of the train step, x (16, 64, 4,
// 112, 112) bf16, window (1, 3, 3) stride (1, 2, 2): xp, y and g read once
// and dx written once, about 0.26 GB, is 0.077 ms at 3.35 TB/s; the compares
// are a few per element.  It is bound by bytes, so it is two short passes
// with no division in their loops and neighbouring threads on neighbouring
// addresses:
//   1. one thread per window j: the tap index of the first tap of xp equal
//      to y[j] (row-major), one byte (`first`, scratch the wrapper
//      allocates);
//   2. one thread per element p of dx: the sum over the covering windows,
//      j descending, of g[j] where first[j] is p's tap in j.
// Both read xp, y, g and first where neighbouring threads read
// (L1/L2 serve the windows' overlap).  A single pass in which each block
// first found its windows' first maxima into shared memory ran at 3-4x
// torch's atomic backward (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_GRID_Y = 65535;
constexpr unsigned char NO_MAX = 0xff;  // a window whose y matches no tap (NaN)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Geom {
  int T, H, W;     // dx (the unpadded input)
  int Tp, Hp, Wp;  // xp (the padded input)
  int To, Ho, Wo;  // y, g and first
  int kt, kh, kw;  // window
  int st, sh, sw;  // stride
  int lt, lh, lw;  // low pads
  int planes;
};

// p / s for p >= 0: the strides are 1 or 2 at every pool of the model
__device__ __forceinline__ int div_s(int p, int s) {
  return s == 1 ? p : (s == 2 ? p >> 1 : p / s);
}

// windows j of one axis that cover padded position p: j*s <= p < j*s + k, 0 <= j < o
__device__ __forceinline__ void covering(int p, int k, int s, int o, int& lo, int& hi) {
  const int a = p - k + 1;
  lo = a <= 0 ? 0 : div_s(a + s - 1, s);
  hi = min(div_s(p, s), o - 1);
}

// the frame (plane, t) of a block in (blockIdx.y, blockIdx.z); false past the last
__device__ __forceinline__ bool block_frame(int frames, int& frame) {
  frame = blockIdx.z * MAX_GRID_Y + blockIdx.y;
  return frame < frames;
}

// pass 1: grid (ceil(Ho * Wo / NTHREADS), frames of y)
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
first_max_kernel(const T* __restrict__ xp, const T* __restrict__ y,
                 unsigned char* __restrict__ first, Geom q) {
  int frame;
  const int hw = blockIdx.x * NTHREADS + threadIdx.x;
  if (!block_frame(q.planes * q.To, frame) || hw >= q.Ho * q.Wo) return;
  const int jt = frame % q.To, jh = hw / q.Wo, jw = hw - jh * q.Wo;
  const long long j = (long long)frame * q.Ho * q.Wo + hw;
  const T* win = xp + (((long long)(frame / q.To) * q.Tp + jt * q.st) * q.Hp + jh * q.sh) *
                          q.Wp + jw * q.sw;
  const float m = to_f(y[j]);
  unsigned char e = NO_MAX;
  int tap = 0;
  for (int u = 0; u < q.kt && e == NO_MAX; ++u) {
    for (int v = 0; v < q.kh && e == NO_MAX; ++v) {
      const T* row = win + ((long long)u * q.Hp + v) * q.Wp;
      for (int c = 0; c < q.kw; ++c, ++tap) {
        if (to_f(row[c]) == m) {
          e = (unsigned char)tap;
          break;
        }
      }
    }
  }
  first[j] = e;
}

// pass 2: grid (ceil(H * W / NTHREADS), frames of dx)
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
gather_kernel(const unsigned char* __restrict__ first, const T* __restrict__ g,
              T* __restrict__ dx, Geom q) {
  int frame;
  const int hw = blockIdx.x * NTHREADS + threadIdx.x;
  if (!block_frame(q.planes * q.T, frame) || hw >= q.H * q.W) return;
  const int t = frame % q.T, h = hw / q.W, w = hw - h * q.W;
  const long long out_base = (long long)(frame / q.T) * q.To * q.Ho * q.Wo;
  const int pt = t + q.lt, ph = h + q.lh, pw = w + q.lw;
  int t0, t1, h0, h1, w0, w1;
  covering(pt, q.kt, q.st, q.To, t0, t1);
  covering(ph, q.kh, q.sh, q.Ho, h0, h1);
  covering(pw, q.kw, q.sw, q.Wo, w0, w1);
  float acc = 0.f;
  // p's windows in order of its offset in them (row-major): j descending
  for (int jt = t1; jt >= t0; --jt) {
    for (int jh = h1; jh >= h0; --jh) {
      for (int jw = w1; jw >= w0; --jw) {
        const long long j = out_base + ((long long)jt * q.Ho + jh) * q.Wo + jw;
        const int me = ((pt - jt * q.st) * q.kh + (ph - jh * q.sh)) * q.kw + (pw - jw * q.sw);
        if (first[j] == me) acc += to_f(g[j]);
      }
    }
  }
  store(dx + (long long)frame * q.H * q.W + hw, acc);
}

dim3 grid_of(int per_frame, int frames) {
  return dim3((per_frame + NTHREADS - 1) / NTHREADS, frames < MAX_GRID_Y ? frames : MAX_GRID_Y,
              (frames + MAX_GRID_Y - 1) / MAX_GRID_Y);
}

template <typename T>
int launch(const void* xp, const void* y, const void* g, void* dx, void* first,
           const Geom& q, cudaStream_t stream) {
  first_max_kernel<T><<<grid_of(q.Ho * q.Wo, q.planes * q.To), NTHREADS, 0, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(y), static_cast<unsigned char*>(first),
      q);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  gather_kernel<T><<<grid_of(q.H * q.W, q.planes * q.T), NTHREADS, 0, stream>>>(
      static_cast<const unsigned char*>(first), static_cast<const T*>(g),
      static_cast<T*>(dx), q);
  return (int)cudaGetLastError();
}

}  // namespace

// xp (planes, Tp, Hp, Wp), y and g (planes, To, Ho, Wo), dx (planes, T, H,
// W), all contiguous, of one type: f32 (bf16 = 0) or bf16 (bf16 = 1);
// first: scratch of planes * To * Ho * Wo bytes.  A pool of lower rank
// passes leading dims of size 1 (window 1, stride 1, pad 0).  Returns the
// CUDA error of the launches (0 on success).
extern "C" int picad_max_pool_bwd(const void* xp, const void* y, const void* g, void* dx,
                                  void* first, int planes, int T, int H, int W, int Tp,
                                  int Hp, int Wp, int To, int Ho, int Wo, int kt, int kh,
                                  int kw, int st, int sh, int sw, int lt, int lh, int lw,
                                  int bf16, void* stream) {
  const long long frames = (long long)planes * (T > To ? T : To);
  if (frames > 0x7fffffffLL || (long long)H * W > 0x7fffffffLL ||
      (long long)Ho * Wo > 0x7fffffffLL || (long long)kt * kh * kw >= NO_MAX)
    return (int)cudaErrorInvalidValue;
  if (frames == 0 || H * W == 0 || Ho * Wo == 0) return 0;
  const Geom q{T, H, W, Tp, Hp, Wp, To, Ho, Wo, kt, kh, kw, st, sh, sw, lt, lh, lw, planes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(xp, y, g, dx, first, q, s)
              : launch<float>(xp, y, g, dx, first, q, s);
}
