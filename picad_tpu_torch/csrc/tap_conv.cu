// Stride-1 VALID convolution as tap GEMMs, for Hopper (sm_90a): the
// forward (K3), the input gradient (K4) and the weight gradient (K5).
//
// Replaces the TPU kernels of picad_tpu/ops/tapconv.py:
//   K3  _chunk_kernel with back_shift 0, driven by _fwd_impl;
//   K4  _chunk_kernel with back_shift = cm, driven by _dx_impl;
//   K5  _dw_kernel (and its layout variant _dw_kernel_dense), driven by
//       _dw_impl.
// With x flattened to the canvas rows (B * prod(spatial), Ci), tap t's flat
// row shift off(t), and base(m) the canvas row of valid output position m:
//
//   K3  out[m, co] = sum_t sum_ci x[base(m) + off(t), ci] W[t, ci, co]
//   K4  dx[p, ci]  = sum_t sum_co gcan[p - off(t), co] W[t, ci, co]
//   K5  dW[t, ci, co] = sum_m x[base(m) + off(t), ci] g[m, co]
//
// gcan is g zero-embedded in the canvas (the wrapper pads it); a row
// before the canvas reads as zero here, from no memory.  Every product is
// of inputs in x's type, summed in f32; K3 and K4 write x's type, K5 f32.
// Up to three spatial dims (leading ones of size 1 for rank 1 and 2).
//
// Design: one implicit-GEMM body for the three.  A block owns a 128 x BN
// tile of the output matrix (BN = 128, or 32 when that side is 32 wide,
// as the activation conv's Co is); 256 threads; the reduction runs in
// steps of BK over (tap, channel chunk) for K3 and K4 and over the valid
// output rows for K5, which gives every (tap, Ci tile, Co tile) its own
// block and writes each dW entry once: no atomics, no split-K, the same
// result on every run.  K3 computes only the valid output rows, so it does
// the useful work and no more; K4 runs over every canvas row (784 per
// sample at 28^2 against 400 useful, 1.96x).  Each step gathers its A rows
// and B rows with 16-byte cp.async copies into a two-stage shared-memory
// ring (a masked copy fills zeros), so the next step's loads fly while
// this one computes.  bf16 multiplies on the tensor cores through
// nvcuda::wmma m16n16k16 fragments with f32 accumulators (warp tile 64 x
// 32, or 16 x 32 when BN = 32); f32 runs on the FP32 cores in full f32,
// never TF32 (8 x 8 or 4 x 4 outputs a thread).
//
// Bound on an H100 SXM at the train shape of PrimaryCaps' pose conv, x
// (16, 28, 28, 832) bf16, W (9, 9, 832, 512): each direction does 441.7
// GFLOP of useful work, 0.447 ms on the dense bf16 tensor cores (989
// TFLOP/s), against ~0.03 ms for its bytes (x 20.9 MB, W 69 MB, out 6.6
// MB; K5's f32 dW 138 MB): bound by operations.  This first version uses
// mma.sync-class wmma fragments, a two-stage ring and no warp
// specialisation; wgmma fed by TMA, deeper pipelines and a persistent
// schedule are the way toward the bound.  f32: 6.59 ms at 67 TFLOP/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int FWD = 0, DX = 1, DW = 2;
constexpr int BM = 128;  // output rows a block
constexpr int NTHREADS = 256;

struct Geo {
  int B, Ci, Co;
  int k[3];      // kernel dims
  int o[3];      // output dims
  int st[3];     // flat row strides of the canvas
  int cs;        // canvas rows a sample
  int os;        // output positions a sample
  int ntaps;
  int Mv;        // valid output rows, B * os
  int Mc;        // canvas rows, B * cs
};

__device__ __forceinline__ int tap_offset(const Geo& g, int t) {
  const int k2 = t % g.k[2];
  const int r = t / g.k[2];
  return (r / g.k[1]) * g.st[0] + (r % g.k[1]) * g.st[1] + k2 * g.st[2];
}

// canvas row of valid output position m
__device__ __forceinline__ int out_base(const Geo& g, int m) {
  const int b = m / g.os;
  int r = m - b * g.os;
  const int i2 = r % g.o[2];
  r /= g.o[2];
  return b * g.cs + (r / g.o[1]) * g.st[0] + (r % g.o[1]) * g.st[1] + i2 * g.st[2];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: read nothing, fill 16 zero bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, int MODE, int BN>
struct Cfg {
  static constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int VEC = 16 / (int)sizeof(T);  // elements a 16-byte copy
  static constexpr int BK = BF16 ? 32 : 16;        // reduction depth a step
  static constexpr int PAD = VEC;                  // 16 bytes a smem row
  static constexpr bool A_COL = MODE == DW;        // A stored [BK][BM]
  static constexpr bool B_COL = MODE == DX;        // B stored [BN][BK]
  static constexpr int LDA = A_COL ? BM + PAD : BK + PAD;
  static constexpr int LDB = B_COL ? BK + PAD : BN + PAD;
  static constexpr int A_ELEMS = A_COL ? BK * LDA : BM * LDA;
  static constexpr int B_ELEMS = B_COL ? BN * LDB : BK * LDB;
  static constexpr int STAGE_BYTES = (A_ELEMS + B_ELEMS) * (int)sizeof(T);
  static_assert((A_ELEMS * (int)sizeof(T)) % 128 == 0 && STAGE_BYTES % 128 == 0,
                "tiles keep 128-byte alignment");
  static_assert(2 * STAGE_BYTES <= 48 * 1024, "static shared memory");
  static_assert(BK / VEC == 4, "four 16-byte copies a row of BK");
};

// Stage step s's A and B tiles (zeros outside the operands).  a_row[q]:
// for K3 the canvas row of this thread's output row q (-1 past the end),
// for K4 its canvas row p (-1 past the end).
template <typename T, int MODE, int BN>
__device__ __forceinline__ void load_step(T* As, T* Bs, const T* __restrict__ a,
                                          const T* __restrict__ b, const Geo& g, int s,
                                          int m0, int n0, int tap, const int a_row[2]) {
  using C = Cfg<T, MODE, BN>;
  constexpr int VEC = C::VEC, BK = C::BK;
  const int tid = threadIdx.x;
  if constexpr (MODE == FWD || MODE == DX) {
    const int K = MODE == FWD ? g.Ci : g.Co;  // A's channels
    const int nck = (K + BK - 1) / BK;
    const int t = s / nck;
    const int c0 = (s - t * nck) * BK;
    const int off = tap_offset(g, t);
    const int c = c0 + (tid & 3) * VEC;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int row = (tid >> 2) + 64 * q;
      const int r = a_row[q] < 0 ? -1 : (MODE == FWD ? a_row[q] + off : a_row[q] - off);
      const bool ok = r >= 0 && c < K;
      cp_async16(As + row * C::LDA + (tid & 3) * VEC, ok ? a + (size_t)r * K + c : a, ok);
    }
    if constexpr (MODE == FWD) {  // B[k][n] = W[t, c0 + k, n0 + n]
      constexpr int VPR = BN / VEC;
      for (int v = tid; v < BK * VPR; v += NTHREADS) {
        const int kr = v / VPR, n = n0 + (v % VPR) * VEC, ci = c0 + kr;
        const bool ok = ci < g.Ci && n < g.Co;
        cp_async16(Bs + kr * C::LDB + (v % VPR) * VEC,
                   ok ? b + ((size_t)t * g.Ci + ci) * g.Co + n : b, ok);
      }
    } else {  // B[k][n] = W[t, n0 + n, c0 + k], stored [n][k]
      for (int v = tid; v < BN * 4; v += NTHREADS) {
        const int nr = v >> 2, ci = n0 + nr, co = c0 + (v & 3) * VEC;
        const bool ok = ci < g.Ci && co < g.Co;
        cp_async16(Bs + nr * C::LDB + (v & 3) * VEC,
                   ok ? b + ((size_t)t * g.Ci + ci) * g.Co + co : b, ok);
      }
    }
  } else {  // DW: A[i][k] = x[base(m0k + k) + off, m0 + i] stored [k][i]; B[k][n] = g[m, n]
    const int mk = s * BK;
    const int off = tap_offset(g, tap);
    constexpr int VPA = BM / VEC;
    for (int v = tid; v < BK * VPA; v += NTHREADS) {
      const int kr = v / VPA, m = mk + kr, ci = m0 + (v % VPA) * VEC;
      const bool ok = m < g.Mv && ci < g.Ci;
      cp_async16(As + kr * C::LDA + (v % VPA) * VEC,
                 ok ? a + (size_t)(out_base(g, m) + off) * g.Ci + ci : a, ok);
    }
    constexpr int VPB = BN / VEC;
    for (int v = tid; v < BK * VPB; v += NTHREADS) {
      const int kr = v / VPB, m = mk + kr, co = n0 + (v % VPB) * VEC;
      const bool ok = m < g.Mv && co < g.Co;
      cp_async16(Bs + kr * C::LDB + (v % VPB) * VEC, ok ? b + (size_t)m * g.Co + co : b, ok);
    }
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

template <typename T, int MODE, int BN, typename OutT>
__device__ __forceinline__ void tap_gemm(const T* __restrict__ a, const T* __restrict__ b,
                                         OutT* __restrict__ out, const Geo& g) {
  using C = Cfg<T, MODE, BN>;
  constexpr int BK = C::BK;
  __shared__ __align__(128) unsigned char smem[2 * C::STAGE_BYTES];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int tap = blockIdx.z;  // K5 only
  const int M = MODE == FWD ? g.Mv : (MODE == DX ? g.Mc : g.Ci);  // rows of the output
  const int N = MODE == DX ? g.Ci : g.Co;
  if constexpr (MODE == DW) out += (size_t)tap * g.Ci * g.Co;

  int a_row[2] = {-1, -1};
  if constexpr (MODE != DW) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int m = m0 + (tid >> 2) + 64 * q;
      if (MODE == FWD && m < g.Mv) a_row[q] = out_base(g, m);
      if (MODE == DX && m < g.Mc) a_row[q] = m;
    }
  }
  const int nsteps = MODE == FWD ? g.ntaps * ((g.Ci + BK - 1) / BK)
                     : MODE == DX ? g.ntaps * ((g.Co + BK - 1) / BK)
                                  : (g.Mv + BK - 1) / BK;
  auto stage_a = [&](int st) { return reinterpret_cast<T*>(smem + st * C::STAGE_BYTES); };
  auto stage_b = [&](int st) { return stage_a(st) + C::A_ELEMS; };

  if constexpr (C::BF16) {
    constexpr int WARPS_N = BN / 32, WARPS_M = 8 / WARPS_N;
    constexpr int WTM = BM / WARPS_M, FM = WTM / 16, FN = 2;
    using LayA = std::conditional_t<C::A_COL, wmma::col_major, wmma::row_major>;
    using LayB = std::conditional_t<C::B_COL, wmma::col_major, wmma::row_major>;
    const int warp = tid >> 5, lane = tid & 31;
    const int wm = warp / WARPS_N, wn = warp % WARPS_N;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    if (nsteps > 0) load_step<T, MODE, BN>(stage_a(0), stage_b(0), a, b, g, 0, m0, n0, tap, a_row);
    cp_async_commit();
    for (int s = 0; s < nsteps; ++s) {
      if (s + 1 < nsteps)
        load_step<T, MODE, BN>(stage_a((s + 1) & 1), stage_b((s + 1) & 1), a, b, g, s + 1, m0,
                               n0, tap, a_row);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const T* As = stage_a(s & 1);
      const T* Bs = stage_b(s & 1);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LayA> fa[FM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LayB> fb[FN];
#pragma unroll
        for (int i = 0; i < FM; ++i) {
          const int r = wm * WTM + i * 16;
          wmma::load_matrix_sync(fa[i], C::A_COL ? As + kk * C::LDA + r : As + r * C::LDA + kk,
                                 C::LDA);
        }
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          const int c = wn * 32 + j * 16;
          wmma::load_matrix_sync(fb[j], C::B_COL ? Bs + c * C::LDB + kk : Bs + kk * C::LDB + c,
                                 C::LDB);
        }
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
    cp_async_wait<0>();
    __syncthreads();
    // epilogue: each warp stages one 16 x 16 fragment at a time in its own
    // 1 KB of the (now idle) ring and writes 8 outputs a lane
    float* scratch = reinterpret_cast<float*>(smem) + warp * 256;
    const int r = lane >> 1, c8 = (lane & 1) * 8;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int row = m0 + wm * WTM + i * 16 + r;
        const int col = n0 + wn * 32 + j * 16 + c8;
        if (row < M && col < N) store8(out + (size_t)row * N + col, scratch + r * 16 + c8);
        __syncwarp();
      }
  } else {
    constexpr int THREADS_N = BN >= 64 ? 16 : 8, THREADS_M = NTHREADS / THREADS_N;
    constexpr int TN = BN / THREADS_N, TM = BM / THREADS_M;
    const int tn = tid % THREADS_N, tm = tid / THREADS_N;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    if (nsteps > 0) load_step<T, MODE, BN>(stage_a(0), stage_b(0), a, b, g, 0, m0, n0, tap, a_row);
    cp_async_commit();
    for (int s = 0; s < nsteps; ++s) {
      if (s + 1 < nsteps)
        load_step<T, MODE, BN>(stage_a((s + 1) & 1), stage_b((s + 1) & 1), a, b, g, s + 1, m0,
                               n0, tap, a_row);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const float* As = reinterpret_cast<const float*>(stage_a(s & 1));
      const float* Bs = reinterpret_cast<const float*>(stage_b(s & 1));
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float av[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int r = tm + THREADS_M * i;
          av[i] = C::A_COL ? As[k * C::LDA + r] : As[r * C::LDA + k];
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int c = tn + THREADS_N * j;
          bv[j] = C::B_COL ? Bs[c * C::LDB + k] : Bs[k * C::LDB + c];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
    cp_async_wait<0>();
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = m0 + tm + THREADS_M * i;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = n0 + tn + THREADS_N * j;
        if (col < N) out[(size_t)row * N + col] = acc[i][j];
      }
    }
  }
}

template <typename T, int BN>
__global__ void __launch_bounds__(NTHREADS)
tap_conv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                    Geo g) {
  tap_gemm<T, FWD, BN>(x, w, out, g);
}

template <typename T, int BN>
__global__ void __launch_bounds__(NTHREADS)
tap_conv_dx_kernel(const T* __restrict__ gcan, const T* __restrict__ w, T* __restrict__ dx,
                   Geo g) {
  tap_gemm<T, DX, BN>(gcan, w, dx, g);
}

template <typename T, int BN>
__global__ void __launch_bounds__(NTHREADS)
tap_conv_dw_kernel(const T* __restrict__ x, const T* __restrict__ gout,
                   float* __restrict__ dw, Geo g) {
  tap_gemm<T, DW, BN>(x, gout, dw, g);
}

template <typename T, int BN>
int launch(int mode, const void* a, const void* b, void* out, const Geo& g, cudaStream_t st) {
  const int M = mode == FWD ? g.Mv : (mode == DX ? g.Mc : g.Ci);
  const int N = mode == DX ? g.Ci : g.Co;
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, mode == DW ? g.ntaps : 1);
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  if (mode == FWD)
    tap_conv_fwd_kernel<T, BN><<<grid, NTHREADS, 0, st>>>(ta, tb, static_cast<T*>(out), g);
  else if (mode == DX)
    tap_conv_dx_kernel<T, BN><<<grid, NTHREADS, 0, st>>>(ta, tb, static_cast<T*>(out), g);
  else
    tap_conv_dw_kernel<T, BN><<<grid, NTHREADS, 0, st>>>(ta, tb, static_cast<float*>(out), g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bn(int mode, const void* a, const void* b, void* out, const Geo& g, cudaStream_t st) {
  const int N = mode == DX ? g.Ci : g.Co;
  return N > 32 ? launch<T, 128>(mode, a, b, out, g, st) : launch<T, 32>(mode, a, b, out, g, st);
}

}  // namespace

// mode 0 (K3): a = x (B, *s, Ci), b = W (*k, Ci, Co), out (B, *o, Co);
// mode 1 (K4): a = gcan (B, *s, Co), b = W, out = dx (B, *s, Ci);
// mode 2 (K5): a = x, b = g (B, *o, Co), out = dW (*k, Ci, Co) f32;
// with o = s - k + 1 per spatial dim, three dims (leading ones of size 1).
// a, b and out contiguous and 16-byte aligned; a and b f32 (is_bf16 = 0)
// or bf16 (is_bf16 = 1), out in their type except K5's; Ci % 8 == 0 and
// Co % 8 == 0; every index below 2^31.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int picad_tap_conv(int mode, const void* a, const void* b, void* out, int B,
                              int Ci, int Co, int s0, int s1, int s2, int k0, int k1, int k2,
                              int is_bf16, void* stream) {
  Geo g;
  g.B = B;
  g.Ci = Ci;
  g.Co = Co;
  const int s[3] = {s0, s1, s2};
  const int k[3] = {k0, k1, k2};
  for (int d = 0; d < 3; ++d) {
    g.k[d] = k[d];
    g.o[d] = s[d] - k[d] + 1;
  }
  g.st[2] = 1;
  g.st[1] = s2;
  g.st[0] = s1 * s2;
  g.cs = s0 * s1 * s2;
  g.os = g.o[0] * g.o[1] * g.o[2];
  g.ntaps = k0 * k1 * k2;
  g.Mv = B * g.os;
  g.Mc = B * g.cs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bn<__nv_bfloat16>(mode, a, b, out, g, st)
                 : launch_bn<float>(mode, a, b, out, g, st);
}
