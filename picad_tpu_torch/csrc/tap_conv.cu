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
// Bound on an H100 SXM at the train shape of PrimaryCaps' pose conv, x
// (16, 28, 28, 832) bf16, W (9, 9, 832, 512): each direction does 441.7
// GFLOP of useful work, 0.447 ms on the dense bf16 tensor cores (989
// TFLOP/s), against ~0.03 ms for its bytes (x 20.9 MB, W 69 MB, out 6.6
// MB; K5's f32 dW 138 MB): bound by operations.  The act conv (Co 32)
// does 27.6 GFLOP, 0.028 ms.
//
// bf16 K3 and K4: one Hopper GEMM body (tap_conv_wgmma).  The reduction
// runs in steps of 64 over the flat (tap, channel) index r = i * K + c of
// the block's tap list (K = A's channels), so one step is one 128-byte
// row of A and a narrow K (the act conv's Co = 32 in K4) packs two taps
// into a step instead of padding.  A rows are gathered with 16-byte
// cp.async copies into the 128-byte swizzled layout (K3: x[base(m) +
// off(t)], K4: gcan[p - off(t)]; a row outside the canvas is a copy of
// source size 0: zeros, no memory read).  W tiles are 2-D boxes of the
// (ntaps * Ci, Co) matrix, copied by TMA into the same swizzle (K3: B
// MN-major; K4: K-major, by TMA when a step is one tap, Co % 64 == 0,
// else by cp.async; wgmma's transpose flag, no copy of W).  A ring of NS
// stages in dynamic shared memory (above 48 KB), loads started NS - 2
// steps ahead; every warpgroup multiplies its 64 rows with
// wgmma.mma_async m64nNk16 from shared memory and keeps one group in
// flight.  No warp specialisation: every thread copies its A rows, thread
// 0 starts the TMA copies, then the warpgroups multiply.  The wrapper
// picks the tiles below (tapconv.kernel_tile) and plans with them; a
// launch at a tile this file is not built for returns an error.
//   K3, Co > 64 (the pose conv): 128 x 256 tiles (two warpgroups), a
//     4-stage ring (193 KB, one block an SM).  100 tiles at the train
//     shape (50 x 2) would be 0.76 of a wave on 132 SMs, so the step loop
//     splits into 5 groups: 500 blocks, 3.79 waves; 88 tiles x 3 = 264
//     blocks, 2.0 waves, at serving (tapconv.fwd_split_plan).  Work
//     ratio 1.0.
//   K3, Co <= 64 (the act conv): 64 x 64 tiles (Co 32 padded to 64 in
//     the tensor cores: work ratio 2.0), a 4-stage ring (65 KB, three
//     blocks an SM), and the step loop split into S groups so that about
//     8 x 132 blocks run (S = 11 at the train shape: 1100 blocks; 12 at
//     serving).
//   K3 split into groups: each writes f32 partials to a workspace, and
//     tap_conv_fwd_reduce sums them in a fixed order (no atomics: the
//     same result on every run).
//   K4: 192-row tiles of canvas rows (three warpgroups), and for each
//     tile only the taps whose gcan rows can be non-zero for one of its
//     rows (a table the wrapper computes per geometry,
//     tapconv.dx_tap_table): 1.85x the useful work at 28^2 -> 20^2 with
//     9 x 9 taps, against 1.96x for every canvas row and tap (64-row
//     tiles waste less, 1.53x, but were slower: every row of A and W
//     costs the same copy, and a taller tile copies less W per row).  N
//     tile 208 for Ci = 832 (4 x 208, no padding): 264 blocks at the train
//     shape, 2.0 waves of one block an SM (4-stage ring, 201 KB).
// f32 K3/K4/K5 keep the first version's FP32-core body (full f32, never
// TF32), and bf16 K5 its wmma body: a 128 x BN tile (BN 128, or 32 for
// an output of at most 32 columns), 256 threads,
// two-stage cp.async ring in static shared memory; K5 gives every (tap,
// Ci tile, Co tile) its own block and writes each dW entry once.

#include <cuda.h>
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
  if constexpr (std::is_same<T, float>::value) {
    if (mode == FWD) {
      tap_conv_fwd_kernel<T, BN><<<grid, NTHREADS, 0, st>>>(ta, tb, static_cast<T*>(out), g);
      return (int)cudaGetLastError();
    }
    if (mode == DX) {
      tap_conv_dx_kernel<T, BN><<<grid, NTHREADS, 0, st>>>(ta, tb, static_cast<T*>(out), g);
      return (int)cudaGetLastError();
    }
  } else if (mode != DW) {  // bf16 K3 and K4 run the wgmma body (launch_wgmma)
    return (int)cudaErrorInvalidValue;
  }
  tap_conv_dw_kernel<T, BN><<<grid, NTHREADS, 0, st>>>(ta, tb, static_cast<float*>(out), g);
  return (int)cudaGetLastError();
}

// the first body at the caller's tile, bm x bn with reduction steps of
// bk: one of those it is built for, or cudaErrorInvalidValue
template <typename T>
int launch_tile(int mode, int bm, int bn, int bk, const void* a, const void* b, void* out,
                const Geo& g, cudaStream_t st) {
  if (bm == BM && bk == Cfg<T, DW, 128>::BK) {
    if (bn == 128) return launch<T, 128>(mode, a, b, out, g, st);
    if (bn == 32) return launch<T, 32>(mode, a, b, out, g, st);
  }
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------- bf16 K3 and K4 on wgmma

constexpr int HBK = 64;  // reduction depth a step: one 128-byte row of bf16

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | static_cast<uint64_t>(1) << 62;
}

// byte offset of 16-byte chunk c of 128-byte row r in a swizzled tile
// (the tile starts on a 1024-byte boundary)
__device__ __forceinline__ int sw128(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// TMA: the box of `map` at (c0 innermost, c1) into shared memory at dst,
// its bytes counted on the mbarrier bar
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], f32 += bf16 * bf16; A K-major,
// B K-major (TB = 0) or MN-major (TB = 1), both from shared memory
template <int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_n208(float (&d)[104], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %106, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103"
      "}, %104, %105, p, 1, 1, 0, %107;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}
template <int N, int TB>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 64) wgmma_n64<TB>(d, da, db);
  else if constexpr (N == 208) wgmma_n208<TB>(d, da, db);
  else wgmma_n256<TB>(d, da, db);
}

template <int MODE, int WGM, int BN>
struct HCfg {
  static constexpr int BM = 64 * WGM;  // output rows a block: 64 a warpgroup
  static constexpr int THREADS = 128 * WGM;
  static constexpr int A_BYTES = BM * 128;
  // K3: BN / 64 column blocks of 64 k-rows x 128 B; K4: BN rows of 128 B
  static constexpr int B_BYTES = BN * 128;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // ring stages: as many as 224 KB holds, up to 6; a 16 KB stage (K3's
  // 64 x 64 tile) takes 4, so that three blocks share an SM
  static constexpr int NS = STAGE <= 16384 ? 4 : (229376 / STAGE < 6 ? 229376 / STAGE : 6);
  static constexpr int AHEAD = NS - 2;  // steps loaded ahead of the one multiplied
  static constexpr int SMEM = NS * STAGE + 1024 + 64;  // + 1 KB alignment, NS mbarriers
  static constexpr int A_ROWS = BM * 8 / THREADS;  // A rows a thread copies a step
  static_assert(MODE == DX || BN % 64 == 0, "K3's MN-major B comes in 64-column blocks");
  static_assert(BN % 8 == 0 && BN <= 256 && NS >= 3 && A_ROWS == 4, "tile");
  static_assert(STAGE % 1024 == 0, "stages keep the swizzle's 1 KB alignment");
};

// One block: a BM x BN tile of out (K3: valid output rows x Co; K4: canvas
// rows x Ci).  K3: the tap list is every tap and blockIdx.z picks steps
// [z * steps_per_split, ...) of it; with ws, f32 partials go to ws[z].
// K4: the list is row blockIdx.x of `taps` ([count, tap, ...]).  BTMA: the
// B tiles come by TMA from bmap, W as the 2-D (ntaps * Ci, Co) matrix in
// boxes of 64 columns (K3: 64 rows; K4: BN rows, one tap a step, which
// needs Co % 64 == 0); else by cp.async.
template <int MODE, int WGM, int BN, bool BTMA>
__device__ __forceinline__ void tap_conv_wgmma(const __nv_bfloat16* __restrict__ a,
                                               const __nv_bfloat16* __restrict__ b,
                                               const CUtensorMap* bmap,
                                               __nv_bfloat16* __restrict__ out,
                                               float* __restrict__ ws, const int* __restrict__ taps,
                                               int tap_stride, int steps_per_split, const Geo& g) {
  using C = HCfg<MODE, WGM, BN>;
  static_assert(MODE == DX || BTMA, "K3 takes its B tiles by TMA");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * BN;
  const int K = MODE == FWD ? g.Ci : g.Co;  // A's channels
  const int N = MODE == FWD ? g.Co : g.Ci;
  const int M = MODE == FWD ? g.Mv : g.Mc;
  const int* list = nullptr;  // nullptr: every tap in order
  int nlist = g.ntaps;
  if constexpr (MODE == DX) {
    list = taps + static_cast<size_t>(blockIdx.x) * tap_stride;
    nlist = list[0];
    ++list;
  }
  const int total = nlist * K;  // flat reduction length
  int s0 = 0, nsteps = (total + HBK - 1) / HBK;
  if constexpr (MODE == FWD) {
    s0 = blockIdx.z * steps_per_split;
    nsteps = max(0, min(nsteps - s0, steps_per_split));
  }

  const int c = tid & 7;  // this thread's 16-byte chunk of a 128-byte row
  int a_row[C::A_ROWS];   // canvas row of each A row this thread copies (-1: none)
#pragma unroll
  for (int j = 0; j < C::A_ROWS; ++j) {
    const int m = m0 + (tid >> 3) + j * (C::THREADS / 8);
    a_row[j] = m < M ? (MODE == FWD ? out_base(g, m) : m) : -1;
  }
  const uint32_t bars = smem_addr(smem + C::NS * C::STAGE);  // mbarrier of stage i: bars + 8 i
  if constexpr (BTMA) {
    if (tid == 0) {
      for (int i = 0; i < C::NS; ++i) mbar_init(bars + 8 * i);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  auto load = [&](int s, int buf) {
    unsigned char* As = smem + buf * C::STAGE;
    unsigned char* Bs = As + C::A_BYTES;
    const int r = (s0 + s) * HBK + c * 8;  // chunk c's reduction index
    int tap = -1, ch = 0;
    if (r < total) {
      const int i = r / K;
      ch = r - i * K;
      tap = list ? list[i] : i;
    }
    const int off = tap >= 0 ? tap_offset(g, tap) : 0;
#pragma unroll
    for (int j = 0; j < C::A_ROWS; ++j) {
      const int row = (tid >> 3) + j * (C::THREADS / 8);
      const int src = a_row[j] < 0 || tap < 0 ? -1 : (MODE == FWD ? a_row[j] + off : a_row[j] - off);
      const bool ok = src >= 0;
      cp_async16(As + sw128(row, c), ok ? a + static_cast<size_t>(src) * K + ch : a, ok);
    }
    if constexpr (BTMA) {
      if (tid == 0) {
        const uint32_t bar = bars + 8 * buf;
        const int r0 = (s0 + s) * HBK;  // the step's first reduction index
        mbar_expect_tx(bar, C::B_BYTES);
        if constexpr (MODE == FWD) {  // B[k][n] = W2d[r0 + k, n0 + n]: MN-major blocks
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_2d(smem_addr(Bs) + j * 8192, bmap, n0 + 64 * j, r0, bar);
        } else {  // B[n][k] = W2d[tap * Ci + n0 + n, ch + k]: K-major rows
          const int i = r0 / K;
          tma_load_2d(smem_addr(Bs), bmap, r0 - i * K, list[i] * g.Ci + n0, bar);
        }
      }
    } else {  // K4: B[n][k] = W[tap(k), n0 + n, ch(k)], k contiguous
#pragma unroll
      for (int row = tid >> 3; row < BN; row += C::THREADS / 8) {
        const int n = n0 + row;
        const bool ok = tap >= 0 && n < N;
        cp_async16(Bs + sw128(row, c),
                   ok ? b + (static_cast<size_t>(tap) * g.Ci + n) * g.Co + ch : b, ok);
      }
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int wg = tid >> 7;  // this warpgroup's 64 rows of the tile
#pragma unroll
  for (int i = 0; i < C::AHEAD; ++i) {
    if (i < nsteps) load(i, i);
    cp_async_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    // step s has landed (for every thread), and every warpgroup's
    // wgmma of step s - 2 has finished: its stage takes step s + AHEAD
    cp_async_wait<C::AHEAD - 1>();
    if constexpr (BTMA) mbar_wait(bars + 8 * (s % C::NS), (s / C::NS) & 1);
    fence_proxy_async();
    __syncthreads();
    if (s + C::AHEAD < nsteps) load(s + C::AHEAD, (s + C::AHEAD) % C::NS);
    cp_async_commit();
    const unsigned char* As = smem + (s % C::NS) * C::STAGE;
    const uint32_t a_addr = smem_addr(As) + wg * 8192;
    const uint32_t b_addr = smem_addr(As + C::A_BYTES);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HBK / 16; ++kk) {
      const uint64_t da = sw128_desc(a_addr + kk * 32, 16, 1024);
      const uint64_t db = MODE == FWD ? sw128_desc(b_addr + kk * 2048, 8192, 1024)
                                      : sw128_desc(b_addr + kk * 32, 16, 1024);
      wgmma<BN, MODE == FWD ? 1 : 0>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();

  // accumulator layout of m64nN: element i of lane l in warp w of the
  // warpgroup is row w * 16 + l / 4 + 8 * ((i / 2) % 2), column
  // (i / 4) * 8 + (l % 4) * 2 + i % 2
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int row0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
  float* part = ws ? ws + static_cast<size_t>(blockIdx.z) * M * N : nullptr;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int row = row0 + ((i >> 1) & 1) * 8;
    const int col = n0 + (i >> 2) * 8 + (lane & 3) * 2;
    if (row < M && col < N) {
      const size_t o = static_cast<size_t>(row) * N + col;
      if (part)
        *reinterpret_cast<float2*>(part + o) = make_float2(acc[i], acc[i + 1]);
      else
        *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

template <int WGM, int BN>
__global__ void __launch_bounds__(128 * WGM)
tap_conv_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                          const __grid_constant__ CUtensorMap wmap,
                          __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                          int steps_per_split, Geo g) {
  tap_conv_wgmma<FWD, WGM, BN, true>(x, w, &wmap, out, ws, nullptr, 0, steps_per_split, g);
}

constexpr int DX_WGM = 3;  // bf16 K4's tile: 192 canvas rows

template <int BN, bool BTMA>
__global__ void __launch_bounds__(128 * DX_WGM)
tap_conv_dx_wgmma_kernel(const __nv_bfloat16* __restrict__ gcan, const __nv_bfloat16* __restrict__ w,
                         const __grid_constant__ CUtensorMap wmap,
                         __nv_bfloat16* __restrict__ dx, const int* __restrict__ taps,
                         int tap_stride, Geo g) {
  tap_conv_wgmma<DX, DX_WGM, BN, BTMA>(gcan, w, &wmap, dx, nullptr, taps, tap_stride, 0, g);
}

// K3's second pass: out = sum over the S partials in order, in x's type
__global__ void tap_conv_fwd_reduce_kernel(const float4* __restrict__ ws,
                                           __nv_bfloat16* __restrict__ out, int splits,
                                           size_t n4) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float4 v = ws[i];
    for (int s = 1; s < splits; ++s) {
      const float4 u = ws[s * n4 + i];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out) + 2 * i;
    o[0] = __floats2bfloat162_rn(v.x, v.y);
    o[1] = __floats2bfloat162_rn(v.z, v.w);
  }
}

template <typename Kern>
int set_smem(Kern kern, int bytes) {
  static_assert(std::is_pointer<Kern>::value, "a kernel");
  return static_cast<int>(
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// cuTensorMapEncodeTiled, looked up at run time (no -lcuda at build time)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                : nullptr;
  }();
  return fn;
}

// W as the 2-D (ntaps * Ci, Co) bf16 matrix, boxes of 64 columns x
// box_rows rows in the 128-byte swizzle (zeros outside W)
int w_tensor_map(CUtensorMap* map, const void* w, const Geo& g, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(g.Co),
                              static_cast<cuuint64_t>(g.ntaps) * g.Ci};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(g.Co) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int WGM, int BN>
int launch_fwd_wgmma(const void* x, const void* w, void* out, float* ws, int splits, const Geo& g,
                     cudaStream_t st) {
  using C = HCfg<FWD, WGM, BN>;
  auto kern = tap_conv_fwd_wgmma_kernel<WGM, BN>;
  if (const int err = set_smem(kern, C::SMEM)) return err;
  CUtensorMap wmap;
  if (const int err = w_tensor_map(&wmap, w, g, HBK)) return err;
  const int nsteps = (g.ntaps * g.Ci + HBK - 1) / HBK;
  const int per = (nsteps + splits - 1) / splits;
  const dim3 grid((g.Mv + C::BM - 1) / C::BM, (g.Co + BN - 1) / BN, splits);
  auto* o = static_cast<__nv_bfloat16*>(out);
  kern<<<grid, C::THREADS, C::SMEM, st>>>(static_cast<const __nv_bfloat16*>(x),
                                          static_cast<const __nv_bfloat16*>(w), wmap, o,
                                          splits > 1 ? ws : nullptr, per, g);
  if (splits > 1) {
    const size_t n4 = static_cast<size_t>(g.Mv) * g.Co / 4;
    const int blocks = static_cast<int>((n4 + 255) / 256 < 4096 ? (n4 + 255) / 256 : 4096);
    tap_conv_fwd_reduce_kernel<<<blocks, 256, 0, st>>>(reinterpret_cast<const float4*>(ws), o,
                                                       splits, n4);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_dx_wgmma(const void* gcan, const void* w, void* dx, const int* taps, int tap_stride,
                    const Geo& g, cudaStream_t st) {
  using C = HCfg<DX, DX_WGM, BN>;
  CUtensorMap wmap = {};
  const bool tma = g.Co % HBK == 0;  // one tap a step: W's rows are a box
  if (tma)
    if (const int err = w_tensor_map(&wmap, w, g, BN)) return err;
  auto kern = tma ? tap_conv_dx_wgmma_kernel<BN, true> : tap_conv_dx_wgmma_kernel<BN, false>;
  if (const int err = set_smem(kern, C::SMEM)) return err;
  const dim3 grid((g.Mc + C::BM - 1) / C::BM, (g.Ci + BN - 1) / BN);
  kern<<<grid, C::THREADS, C::SMEM, st>>>(static_cast<const __nv_bfloat16*>(gcan),
                                          static_cast<const __nv_bfloat16*>(w), wmap,
                                          static_cast<__nv_bfloat16*>(dx), taps, tap_stride, g);
  return static_cast<int>(cudaGetLastError());
}

// bf16 K3 and K4 at the caller's tile (K4's tap table has a row for each
// bm canvas rows): one of those the body is built for, or
// cudaErrorInvalidValue
int launch_wgmma(int mode, int bm, int bn, int bk, const void* a, const void* b, void* out,
                 const int* taps, int tap_stride, float* ws, int splits, const Geo& g,
                 cudaStream_t st) {
  const bool empty = mode == FWD ? g.Mv == 0 || g.Co == 0 : g.Mc == 0 || g.Ci == 0;
  if (bk == HBK && mode == FWD) {
    if (bm == 64 && bn == 64) return empty ? 0 : launch_fwd_wgmma<1, 64>(a, b, out, ws, splits, g, st);
    if (bm == 128 && bn == 256)
      return empty ? 0 : launch_fwd_wgmma<2, 256>(a, b, out, ws, splits, g, st);
  }
  if (bk == HBK && mode == DX && bm == 64 * DX_WGM) {
    if (bn == 64) return empty ? 0 : launch_dx_wgmma<64>(a, b, out, taps, tap_stride, g, st);
    if (bn == 208) return empty ? 0 : launch_dx_wgmma<208>(a, b, out, taps, tap_stride, g, st);
    if (bn == 256) return empty ? 0 : launch_dx_wgmma<256>(a, b, out, taps, tap_stride, g, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// mode 0 (K3): a = x (B, *s, Ci), b = W (*k, Ci, Co), out (B, *o, Co);
// mode 1 (K4): a = gcan (B, *s, Co), b = W, out = dx (B, *s, Ci);
// mode 2 (K5): a = x, b = g (B, *o, Co), out = dW (*k, Ci, Co) f32;
// with o = s - k + 1 per spatial dim, three dims (leading ones of size 1).
// a, b and out contiguous and 16-byte aligned; a and b f32 (is_bf16 = 0)
// or bf16 (is_bf16 = 1), out in their type except K5's; Ci % 8 == 0 and
// Co % 8 == 0; every index below 2^31.  The tile is the caller's
// (tapconv.kernel_tile): bm x bn outputs a block, reduction steps of bk;
// one the kernel is not built for is refused with cudaErrorInvalidValue.
// bf16 K4 also takes `taps`, int32 (ceil(B * prod(s) / bm), tap_stride):
// row i = [count, tap, ...], the taps of canvas rows [bm i, bm i + bm)
// (tapconv.dx_tap_table); bf16 K3 with splits > 1 takes `ws`, f32
// (splits, B * prod(o), Co), and splits no larger than its steps
// (ceil(prod(k) * Ci / bk)) with none left empty.  Other modes and types
// ignore taps, ws and splits.  Launches on `stream`, does not
// synchronise, and returns the CUDA error (0 on success).
extern "C" int picad_tap_conv(int mode, const void* a, const void* b, void* out, int B,
                              int Ci, int Co, int s0, int s1, int s2, int k0, int k1, int k2,
                              int is_bf16, int bm, int bn, int bk, const int* taps,
                              int tap_stride, void* ws, int splits, void* stream) {
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
  if (!is_bf16) return launch_tile<float>(mode, bm, bn, bk, a, b, out, g, st);
  if (mode == DW) return launch_tile<__nv_bfloat16>(mode, bm, bn, bk, a, b, out, g, st);
  return launch_wgmma(mode, bm, bn, bk, a, b, out, taps, tap_stride, static_cast<float*>(ws),
                      splits, g, st);
}
