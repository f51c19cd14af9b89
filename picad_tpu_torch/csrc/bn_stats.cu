// BatchNorm batch statistics per group, for Hopper (sm_90a).
//
// Replaces the TPU kernel picad_tpu/ops/bn_stats.py:_stats_pallas (the
// dual reduction behind group_stats).  For the port's channels-first BN
// input x (N, C, S), S = T*H*W, with the batch split into G contiguous
// groups of n = N / G samples, it returns per (g, c) the mean and the
// BIASED variance over the n * S elements of the group's channel c, as f32.
//
// Numerics are those of the TPU kernel: a shifted dual reduction.  The
// shift is the mean of the first min(S, 1024) elements of the group's
// first (sample, channel) plane, a sample of the data near the mean, so
// var = E[(x - s)^2] - E[x - s]^2 keeps two-pass accuracy where the
// textbook E[x^2] - E[x]^2 cancels catastrophically (|mean| >> std).
// The plain version (ops/bn_stats.py) takes the same shift.
//
// It reads the (N, C, S) layout directly: each (n, c) plane is one
// contiguous run of S elements, so there is no transpose to the TPU's
// (G, n, C).  Pass 1: one block per plane sums (x - s) and (x - s)^2 in
// f32 (16-byte loads where the plane is aligned) and reduces in a fixed
// order; every block computes its group's shift itself from the same
// elements in the same order, so all agree.  Pass 2: one thread per
// (g, c) sums its n planes' partials in sample order.  No atomics: the
// result is the same from run to run.
//
// Bound on an H100 SXM at the stem BN of the train step, x (16, 64, 4,
// 112, 112) bf16 and G = 2: 102.8 MB read once is 0.031 ms at 3.35 TB/s;
// the 2 FLOP per element are negligible.  So it is bound by bytes, and
// the design keeps one read of x, wide loads, and enough blocks (one per
// plane, 1024 at the stem) to keep the memory system busy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int SHIFT_N = 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16 bytes of x as floats
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// sum of v over the block, fixed order; every thread gets the result
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NTHREADS / 32; ++w) s += red[w];
  return s;
}

template <typename Tin>
__global__ void __launch_bounds__(NTHREADS)
plane_sums(const Tin* __restrict__ x, float* __restrict__ part,
           float* __restrict__ shift_out, int N, int C, int S, int n_per_group,
           int vec_ok) {
  __shared__ float red[NTHREADS / 32];
  const int plane = blockIdx.x;  // n * C + c
  const int n = plane / C, c = plane - (plane / C) * C;
  const int g = n / n_per_group;
  const Tin* xp = x + (size_t)plane * S;

  // the group's shift: mean of the first K elements of plane (g * n, c)
  const int K = min(S, SHIFT_N);
  const Tin* sp = x + ((size_t)(g * n_per_group) * C + c) * S;
  float s0 = 0.f;
  for (int i = threadIdx.x; i < K; i += NTHREADS) s0 += to_f(sp[i]);
  const float shift = block_sum(s0, red) / (float)K;

  float s1 = 0.f, s2 = 0.f;
  constexpr int VEC = 16 / sizeof(Tin);
  if (vec_ok) {
    const int nv = S / VEC;
#pragma unroll 4
    for (int i = threadIdx.x; i < nv; i += NTHREADS) {
      float v[VEC];
      load_vec(xp + (size_t)i * VEC, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float d = v[k] - shift;
        s1 += d;
        s2 = fmaf(d, d, s2);
      }
    }
  } else {
    for (int i = threadIdx.x; i < S; i += NTHREADS) {
      const float d = to_f(xp[i]) - shift;
      s1 += d;
      s2 = fmaf(d, d, s2);
    }
  }
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  if (threadIdx.x == 0) {
    part[2 * (size_t)plane] = s1;
    part[2 * (size_t)plane + 1] = s2;
    if (n == g * n_per_group) shift_out[g * C + c] = shift;
  }
}

__global__ void group_finish(const float* __restrict__ part,
                             const float* __restrict__ shift, float* __restrict__ mean,
                             float* __restrict__ var, int G, int C, int S,
                             int n_per_group) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;  // g * C + c
  if (e >= G * C) return;
  const int g = e / C, c = e - (e / C) * C;
  float s1 = 0.f, s2 = 0.f;
  for (int i = 0; i < n_per_group; ++i) {
    const size_t plane = (size_t)(g * n_per_group + i) * C + c;
    s1 += part[2 * plane];
    s2 += part[2 * plane + 1];
  }
  const float cnt = (float)n_per_group * (float)S;
  const float m1 = s1 / cnt;
  mean[e] = m1 + shift[e];
  var[e] = fmaxf(s2 / cnt - m1 * m1, 0.f);
}

template <typename Tin>
int launch(const void* x, void* part, void* shift, void* mean, void* var, int N,
           int C, int S, int G, cudaStream_t stream) {
  const int n_per_group = N / G;
  const int vec_ok = (S % (16 / (int)sizeof(Tin)) == 0) &&
                     (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  plane_sums<Tin><<<N * C, NTHREADS, 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<float*>(part),
      static_cast<float*>(shift), N, C, S, n_per_group, vec_ok);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  group_finish<<<(G * C + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const float*>(shift),
      static_cast<float*>(mean), static_cast<float*>(var), G, C, S, n_per_group);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, C, S) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); N % G
// == 0.  Writes mean and var, each (G, C) f32, using part (N, C, 2) and
// shift (G, C) f32 as scratch.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int picad_bn_stats(const void* x, void* part, void* shift, void* mean,
                              void* var, int N, int C, int S, int G, int is_bf16,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, part, shift, mean, var, N, C, S, G, s)
                 : launch<float>(x, part, shift, mean, var, N, C, S, G, s);
}
