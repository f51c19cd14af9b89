// Composite ConvT forward of the fused decoder head, for Hopper (sm_90a).
//
// Replaces the TPU kernel picad_tpu/ops/pallas_fused_head.py:_fwd_kernel
// (driven by _composite_fwd_impl / composite_convt).  It computes the raw
// composite scatter of fused_head._raw_fused at d = 3:
//
//   out[b, 2i - 2 + tau] += Kc[b, tau, :] . x[b, i, :]      per axis,
//
// i.e. a per-sample ConvT(k5, s2, p2, op1) contracted over channels, with
// x (B, T, H, W, C) channels-last, Kc (B, 125, C) in x's type, and the
// output (B, 2T, 2H, 2W) f32 written interleaved.  Accumulation is f32.
//
// What the TPU kernel keeps out of device memory, this one does too: the
// (B, T, H, W, 125) tap tensor of the plain formulation never exists.
// The design is output-stationary gather.  Write each output position as
// o = 2 o' + phi per axis (phi the output phase).  Input neighbour
// i = o' + s, s in {-1, 0, 1}, reaches phase phi through exactly one tap
// per axis (s = +1: tau = phi; s = 0: tau = 2 + phi; s = -1: tau = 4, phase
// 0 only), so the 8 outputs at o' need the 27 neighbours x[o' + s] and all
// 125 taps once each: no redundant work, 8 to 27 taps per output.
//
// One block owns (b, t', a 16 x 16 tile of (h', w')).  Per 8-channel step
// it stages the 3 x 18 x 18 halo of x and the 125 x 8 slice of Kc in
// shared memory as f32 (bf16 widened once here), and each thread
// accumulates the 8 phases of 4 vertically adjacent o' in 32 registers.
// Lanes run along w' so staged-x reads are conflict-free (position stride
// 12 floats) and Kc reads are warp-wide broadcasts.
//
// Bound on an H100 SXM at the serving shape B = 14, x (14, 4, 112, 112, 128)
// bf16: 202 MB moved (x 179.8 MB read, out 22.5 MB written, Kc 0.45 MB)
// is 60 us at 3.35 TB/s; 22.5 GFLOP is 23 us on bf16 tensor cores but
// 0.34 ms on the FP32 CUDA cores this kernel uses.  This first kernel is
// therefore bound by FP32 FMA issue, not by memory; it keeps the FMA
// pipe fed (4 o' per thread so one broadcast Kc load serves 4 FMAs per
// lane, f32 staging so the inner loop has no conversions).  Tensor cores
// (wgmma), TMA and warp specialisation are the way to the 60 us bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 16;                   // tile width in w' (one lane each)
constexpr int RPT = 4;                   // o' rows per thread
constexpr int HG = 2;                    // row groups per warp (half-warps)
constexpr int NWARPS = 2;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int TH = HG * NWARPS * RPT;    // tile height in h' (16)
constexpr int CC = 8;                    // channels staged per step
constexpr int XS = 12;                   // padded float stride per position
constexpr int SR = TH + 2;               // staged rows (1-row halo each side)
constexpr int SC = TW + 2;               // staged cols
constexpr int NPOS = 3 * SR * SC;        // staged positions (3 frames)
constexpr int NTAPS = 125;
constexpr int X_FLOATS = NPOS * XS;
constexpr int K_FLOATS = NTAPS * CC;
constexpr int SMEM_BYTES = (X_FLOATS + K_FLOATS) * (int)sizeof(float);

static_assert(HG * 16 == 32, "a warp is HG half-warps of TW lanes");
static_assert(TW == 16, "lane layout assumes 16 columns per half-warp");

// Per axis, neighbour index d = s + 1 feeds n_phase(d) output phases;
// phase phi takes tap tau_of(d, phi).
__host__ __device__ constexpr int n_phase(int d) { return d == 0 ? 1 : 2; }
__host__ __device__ constexpr int tau_of(int d, int phi) {
  return d == 0 ? 4 : (d == 1 ? 2 + phi : phi);
}

__device__ __forceinline__ void load8(const float* src, float* v) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* v) {
  // 8 bf16 in one 16-byte load; element 2k is the low half of word k.
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

template <typename Tin>
__global__ void __launch_bounds__(NTHREADS)
composite_convt_kernel(const Tin* __restrict__ x, const Tin* __restrict__ kc,
                       float* __restrict__ out, int T, int H, int W, int C) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [3][SR][SC][XS]
  float* ks = xs + X_FLOATS;                    // [NTAPS][CC]

  const int b = blockIdx.z / T;
  const int t = blockIdx.z - b * T;
  const int h0 = blockIdx.y * TH;
  const int w0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int lw = lane & 15;                         // w' within the tile
  const int r0 = ((tid >> 5) * HG + (lane >> 4)) * RPT;  // first o' row

  const Tin* xb = x + (size_t)b * T * H * W * C;
  const Tin* kb = kc + (size_t)b * NTAPS * C;

  float acc[RPT][2][2][2] = {};

  for (int c0 = 0; c0 < C; c0 += CC) {
    __syncthreads();  // the previous step's reads are done
    for (int p = tid; p < NPOS; p += NTHREADS) {
      const int dt = p / (SR * SC);
      const int rem = p - dt * (SR * SC);
      const int r = rem / SC;
      const int c = rem - r * SC;
      const int ti = t + dt - 1, hi = h0 + r - 1, wi = w0 + c - 1;
      float v[CC];
      if (ti >= 0 && ti < T && hi >= 0 && hi < H && wi >= 0 && wi < W) {
        load8(xb + (((size_t)ti * H + hi) * W + wi) * C + c0, v);
      } else {
#pragma unroll
        for (int i = 0; i < CC; ++i) v[i] = 0.f;
      }
      store8(xs + p * XS, v);
    }
    for (int p = tid; p < NTAPS; p += NTHREADS) {
      float v[CC];
      load8(kb + (size_t)p * C + c0, v);
      store8(ks + p * CC, v);
    }
    __syncthreads();

#pragma unroll
    for (int dt = 0; dt < 3; ++dt) {
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
#pragma unroll
        for (int cv = 0; cv < CC / 4; ++cv) {
          // staged rows r0 .. r0 + RPT + 1 at column lw + dw: row j is the
          // neighbour of o' row k with vertical shift s = j - k - 1
          float4 xv[RPT + 2];
#pragma unroll
          for (int j = 0; j < RPT + 2; ++j)
            xv[j] = *reinterpret_cast<const float4*>(
                xs + ((dt * SR + r0 + j) * SC + lw + dw) * XS + cv * 4);
#pragma unroll
          for (int dh = 0; dh < 3; ++dh)
#pragma unroll
            for (int pt = 0; pt < n_phase(dt); ++pt)
#pragma unroll
              for (int ph = 0; ph < n_phase(dh); ++ph)
#pragma unroll
                for (int pw = 0; pw < n_phase(dw); ++pw) {
                  const int tap = tau_of(dt, pt) * 25 + tau_of(dh, ph) * 5 +
                                  tau_of(dw, pw);
                  const float4 kv = *reinterpret_cast<const float4*>(
                      ks + tap * CC + cv * 4);
#pragma unroll
                  for (int k = 0; k < RPT; ++k) {
                    const float4 a = xv[k + dh];
                    float s = acc[k][pt][ph][pw];
                    s = fmaf(a.x, kv.x, s);
                    s = fmaf(a.y, kv.y, s);
                    s = fmaf(a.z, kv.z, s);
                    s = fmaf(a.w, kv.w, s);
                    acc[k][pt][ph][pw] = s;
                  }
                }
        }
      }
    }
  }

  const int wo = w0 + lw;
  if (wo >= W) return;
  const size_t W2 = 2 * (size_t)W;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int ho = h0 + r0 + k;
    if (ho >= H) break;
#pragma unroll
    for (int pt = 0; pt < 2; ++pt)
#pragma unroll
      for (int ph = 0; ph < 2; ++ph) {
        const size_t row =
            ((size_t)b * 2 * T + 2 * t + pt) * (2 * (size_t)H) + 2 * ho + ph;
        *reinterpret_cast<float2*>(out + row * W2 + 2 * wo) =
            make_float2(acc[k][pt][ph][0], acc[k][pt][ph][1]);
      }
  }
}

template <typename Tin>
int launch(const void* x, const void* kc, void* out, int B, int T, int H,
           int W, int C, cudaStream_t stream) {
  // above 48 KB, dynamic shared memory must be opted into; the setting
  // belongs to the current device, so it is made on every launch
  const cudaError_t attr = cudaFuncSetAttribute(
      composite_convt_kernel<Tin>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * T);
  composite_convt_kernel<Tin><<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(kc),
      static_cast<float*>(out), T, H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, T, H, W, C) and kc (B, 125, C) contiguous, both f32 (is_bf16 = 0)
// or both bf16 (is_bf16 = 1); C % 8 == 0; 16-byte aligned pointers.
// out (B, 2T, 2H, 2W) f32.  Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() (0 on success).
extern "C" int picad_composite_convt(const void* x, const void* kc, void* out,
                                     int B, int T, int H, int W, int C,
                                     int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, kc, out, B, T, H, W, C, s)
                 : launch<float>(x, kc, out, B, T, H, W, C, s);
}
