// Composite ConvT backward of the fused decoder head, for Hopper (sm_90a).
//
// Replaces the TPU kernel picad_tpu/ops/pallas_fused_head.py:_bwd_kernel
// (driven by _composite_bwd_impl, reached through composite_convt's
// custom VJP).  With the tap-gathered view of the output gradient
//
//   G[b, i, tau] = g[b, 2i - 2 + tau]     per axis, zero out of range,
//
// it computes both gradients of out[b, 2i - 2 + tau] += Kc[b,tau,:].x[b,i,:]:
//
//   dx[b, i, c]    = sum_tau G[b, i, tau] * Kc[b, tau, c]   (x's type)
//   dKc[b, tau, c] = sum_i   G[b, i, tau] * x[b, i, c]      (f32)
//
// g arrives rounded to x's type (the JAX package rounds it first,
// pallas_fused_head.py:463); every product is taken in f32 and summed in
// f32.  As on the TPU, G never exists in device memory: at the train
// shape (16, 4, 112, 112, 125) it would be 205 MB in bf16.
//
// Design: input-stationary.  One block owns (b, a 16 x 16 tile of (h, w))
// and walks every frame t and every 32-channel chunk.  Per (chunk, t) it
// stages in shared memory, as f32:
//   - the g window that feeds the tile, frames 2t-2 .. 2t+2, rows
//     2h0-2 .. 2h0+32, columns 2w0-2 .. 2w0+32 (5 x 35 x 35, zero outside
//     g), split by row and column parity so that G[p, tau] for the 16
//     positions of a half-warp are 16 consecutive floats;
//   - the tile's x (256 positions x 32 channels) and Kc's 125 x 32 slice.
// dx: thread p forms G[p, tau] from the window and accumulates its 32
// channels over the 125 taps in registers (Kc reads are warp broadcasts).
// dKc: thread (tap group of 4, channel group of 4) accumulates its 16
// entries over the tile's 256 positions, and over all t, in registers,
// then writes one per-block partial (125 x C).  A second kernel sums the
// partials of each b in a fixed order: no atomics, so the result is the
// same from run to run.
//
// Bound on an H100 SXM at the train shape B = 16, x (16, 4, 112, 112, 128)
// bf16: x read 205.5 MB, g read 12.8 MB, dx written 205.5 MB, about 425 MB
// in all, is 0.127 ms at 3.35 TB/s; the 51.4 GFLOP are 0.052 ms on bf16
// tensor cores but 0.77 ms on the FP32 cores this kernel uses.  So this
// first kernel is bound by FP32 FMA issue and shared-memory loads (about
// one load per four FMAs in the dKc loop).  Tensor cores (wgmma over the
// (positions x 125) . (125 x C) and (125 x positions) . (positions x C)
// products), TMA and more reuse per thread are the way to the byte bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 16;                 // tile width in w (lanes)
constexpr int TH = 16;                 // tile height in h
constexpr int NPOS = TW * TH;          // positions per tile = threads
constexpr int NTHREADS = NPOS;
constexpr int CC = 32;                 // channels per chunk
constexpr int XP = CC + 4;             // padded x_s row (floats)
constexpr int NTAPS = 125;
constexpr int GR = TH + 2;             // window half-rows per parity
constexpr int GP = TW + 2;             // window half-cols per parity
constexpr int GPLANE = GR * GP;
constexpr int GW_FLOATS = 5 * 2 * 2 * GPLANE;
constexpr int K_FLOATS = NTAPS * CC;
constexpr int X_FLOATS = NPOS * XP;
constexpr int SMEM_BYTES = (GW_FLOATS + K_FLOATS + X_FLOATS) * (int)sizeof(float);
constexpr int WIN = 2 * TH + 3;        // window rows/cols (35)

static_assert(TW == TH, "the window staging assumes a square tile");
static_assert(NTHREADS == 32 * 8 && CC == 32, "dKc thread map: 32 tap groups x 8 channel groups");

// offset of G[., tau] inside the parity-split window, without the position
__host__ __device__ constexpr int tap_off(int tt, int th, int tw) {
  return ((tt * 2 + (th & 1)) * 2 + (tw & 1)) * GPLANE + (th >> 1) * GP + (tw >> 1);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void load8(const float* src, float* v) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* v) {
  // 8 bf16 in one 16-byte load; element 2k is the low half of word k
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store8(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k]));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k + 1]));
    w[k] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename Tin>
__global__ void __launch_bounds__(NTHREADS)
composite_bwd_kernel(const Tin* __restrict__ g, const Tin* __restrict__ x,
                     const Tin* __restrict__ kc, Tin* __restrict__ dx,
                     float* __restrict__ partial, int T, int H, int W, int C) {
  extern __shared__ float4 smem4[];
  float* gw = reinterpret_cast<float*>(smem4);  // [5][2][2][GR][GP]
  float* ks = gw + GW_FLOATS;                   // [NTAPS][CC]
  float* xs = ks + K_FLOATS;                    // [NPOS][XP]

  const int b = blockIdx.z;
  const int h0 = blockIdx.y * TH;
  const int w0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const int ph = tid / TW, pw = tid % TW;       // this thread's dx position
  const int H2 = 2 * H, W2 = 2 * W, T2 = 2 * T;
  const bool p_ok = (h0 + ph < H) && (w0 + pw < W);
  const int poff = ph * GP + pw;

  // dKc map: 4 taps (tg*4 + j) x 4 channels (cg*4 + k) per thread
  const int tg = tid >> 3, cg = tid & 7;
  int toff[4];
  bool t_ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int tau = tg * 4 + j;
    t_ok[j] = tau < NTAPS;
    const int tt = tau / 25, th = (tau / 5) % 5, tw = tau % 5;
    toff[j] = t_ok[j] ? tap_off(tt, th, tw) : 0;
  }

  const Tin* gb = g + (size_t)b * T2 * H2 * W2;
  const Tin* xb = x + (size_t)b * T * H * W * C;
  const Tin* kb = kc + (size_t)b * NTAPS * C;
  Tin* dxb = dx + (size_t)b * T * H * W * C;
  const int n_tiles = gridDim.x * gridDim.y;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  float* pb = partial + ((size_t)b * n_tiles + tile) * NTAPS * C;

  for (int c0 = 0; c0 < C; c0 += CC) {
    const int nc = min(CC, C - c0);  // a multiple of 8
    __syncthreads();  // the previous chunk's reads of ks are done
    for (int e = tid; e < NTAPS * (CC / 8); e += NTHREADS) {
      const int tau = e / (CC / 8), c8 = (e % (CC / 8)) * 8;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (c8 < nc) load8(kb + (size_t)tau * C + c0 + c8, v);
      store8(ks + tau * CC + c8, v);
    }
    float dk[4][4] = {};

    for (int t = 0; t < T; ++t) {
      __syncthreads();  // the previous frame's reads of gw and xs are done
      // g window, parity-split: row r, column q of the window land at
      // gw[tt][r & 1][q & 1][r >> 1][q >> 1]
      for (int e = tid; e < 5 * WIN * WIN; e += NTHREADS) {
        const int tt = e / (WIN * WIN);
        const int rem = e - tt * (WIN * WIN);
        const int r = rem / WIN, q = rem - (rem / WIN) * WIN;
        const int gf = 2 * t - 2 + tt, gr = 2 * h0 - 2 + r, gc = 2 * w0 - 2 + q;
        float v = 0.f;
        if (gf >= 0 && gf < T2 && gr >= 0 && gr < H2 && gc >= 0 && gc < W2)
          v = to_f(gb[((size_t)gf * H2 + gr) * W2 + gc]);
        gw[((tt * 2 + (r & 1)) * 2 + (q & 1)) * GPLANE + (r >> 1) * GP + (q >> 1)] = v;
      }
      // x tile for this chunk, zero outside x
      for (int e = tid; e < NPOS * (CC / 8); e += NTHREADS) {
        const int p = e / (CC / 8), c8 = (e % (CC / 8)) * 8;
        const int hh = h0 + p / TW, ww = w0 + p % TW;
        float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (c8 < nc && hh < H && ww < W)
          load8(xb + (((size_t)t * H + hh) * W + ww) * C + c0 + c8, v);
        store8(xs + p * XP + c8, v);
      }
      __syncthreads();

      // dx[p, c0 .. c0 + nc) = sum_tau G[p, tau] Kc[tau, c]
      if (p_ok) {
        float acc[CC];
#pragma unroll
        for (int k = 0; k < CC; ++k) acc[k] = 0.f;
#pragma unroll 1
        for (int tt = 0; tt < 5; ++tt) {
#pragma unroll
          for (int th = 0; th < 5; ++th) {
#pragma unroll
            for (int tw = 0; tw < 5; ++tw) {
              const float gv = gw[tap_off(tt, th, tw) + poff];
              const float* kr = ks + (tt * 25 + th * 5 + tw) * CC;
#pragma unroll
              for (int u = 0; u < CC / 4; ++u) {
                const float4 kv = reinterpret_cast<const float4*>(kr)[u];
                acc[4 * u] = fmaf(gv, kv.x, acc[4 * u]);
                acc[4 * u + 1] = fmaf(gv, kv.y, acc[4 * u + 1]);
                acc[4 * u + 2] = fmaf(gv, kv.z, acc[4 * u + 2]);
                acc[4 * u + 3] = fmaf(gv, kv.w, acc[4 * u + 3]);
              }
            }
          }
        }
        Tin* dst = dxb + (((size_t)t * H + h0 + ph) * W + w0 + pw) * C + c0;
#pragma unroll
        for (int c8 = 0; c8 < CC; c8 += 8)
          if (c8 < nc) store8(dst + c8, acc + c8);
      }

      // dKc partial += sum_p G[p, tau] x[p, c] over this frame's tile
#pragma unroll 4
      for (int p = 0; p < NPOS; ++p) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + p * XP + cg * 4);
        const int po = (p / TW) * GP + (p % TW);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float gv = gw[toff[j] + po];
          dk[j][0] = fmaf(gv, xv.x, dk[j][0]);
          dk[j][1] = fmaf(gv, xv.y, dk[j][1]);
          dk[j][2] = fmaf(gv, xv.z, dk[j][2]);
          dk[j][3] = fmaf(gv, xv.w, dk[j][3]);
        }
      }
    }

    if (cg * 4 < nc) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!t_ok[j]) continue;
        float* dst = pb + (size_t)(tg * 4 + j) * C + c0 + cg * 4;
        *reinterpret_cast<float4*>(dst) = make_float4(dk[j][0], dk[j][1], dk[j][2], dk[j][3]);
      }
    }
  }
}

// dkc[b, e] = sum over tiles, in tile order, of partial[b, tile, e]
__global__ void reduce_partials(const float* __restrict__ partial,
                                float* __restrict__ dkc, int n_tiles, int per_b) {
  const int b = blockIdx.y;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= per_b) return;
  const float* src = partial + (size_t)b * n_tiles * per_b + e;
  float s = 0.f;
  for (int i = 0; i < n_tiles; ++i) s += src[(size_t)i * per_b];
  dkc[(size_t)b * per_b + e] = s;
}

template <typename Tin>
int launch(const void* g, const void* x, const void* kc, void* dx, void* partial,
           void* dkc, int B, int T, int H, int W, int C, cudaStream_t stream) {
  // above 48 KB, dynamic shared memory must be opted into; the setting
  // belongs to the current device, so it is made on every launch
  const cudaError_t attr = cudaFuncSetAttribute(
      composite_bwd_kernel<Tin>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  composite_bwd_kernel<Tin><<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      static_cast<const Tin*>(g), static_cast<const Tin*>(x),
      static_cast<const Tin*>(kc), static_cast<Tin*>(dx),
      static_cast<float*>(partial), T, H, W, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int per_b = NTAPS * C;
  const dim3 rgrid((per_b + 255) / 256, B);
  reduce_partials<<<rgrid, 256, 0, stream>>>(static_cast<const float*>(partial),
                                             static_cast<float*>(dkc),
                                             grid.x * grid.y, per_b);
  return (int)cudaGetLastError();
}

}  // namespace

// g (B, 2T, 2H, 2W), x (B, T, H, W, C) and kc (B, 125, C) contiguous, all
// f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1); C % 8 == 0; 16-byte aligned
// x, kc and dx.  Writes dx (B, T, H, W, C) in x's type and dkc (B, 125, C)
// f32, using partial (B, ceil(H/16) * ceil(W/16), 125, C) f32 as scratch.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success).
extern "C" int picad_composite_convt_bwd(const void* g, const void* x, const void* kc,
                                         void* dx, void* partial, void* dkc, int B,
                                         int T, int H, int W, int C, int is_bf16,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? launch<__nv_bfloat16>(g, x, kc, dx, partial, dkc, B, T, H, W, C, s)
             : launch<float>(g, x, kc, dx, partial, dkc, B, T, H, W, C, s);
}
