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
// gcan is g zero-embedded in the canvas (K4's wrapper pads it; K5's
// canvas form lays it out itself); a row before the canvas reads as zero
// here, from no memory.  Every product is
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
// Every bf16 kernel runs on wgmma; f32 K3/K4/K5 run one FP32-core body
// (full f32, never TF32): a 128 x BN tile (BN 128, or 32 for an output of
// at most 32 columns), 256 threads, a two-stage cp.async ring in static
// shared memory.
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
//
// bf16 K5: dW is a GEMM with Ci as its rows, Co as its columns and a
// reduction over positions, so A = x^T lies M-major in shared memory
// (wgmma's A-transpose flag; no copy of x).  128 x 256 tiles (two
// warpgroups; a warpgroup whose 64 Ci rows all lie past Ci issues no
// wgmma), steps of 64 positions, the 4-stage ring; two forms
// (tapconv.dw_plan picks one by Co):
//   Co > 64 (the pose conv): the valid-row form, K3's pattern transposed.
//     Block (Ci tile, Co tile, tap) sums over the valid output positions
//     m: A rows x[base(m) + off(t), ci0 : ci0 + 128] gathered by
//     cp.async (zeros past Mv), B = g as the 2-D (Mv, Co) matrix in TMA
//     boxes of 64 x 64, MN-major.  7 x 2 x 81 = 1134 blocks at the train
//     shape (8.6 waves), each dW entry written once, work ratio 1.0.
//   Co <= 64 (the act conv): the canvas form, dW[t] = sum_p x[p] (x)
//     gcan[p - off(t)] over every canvas row p, so one A tile of x rows
//     (two TMA boxes) serves every tap of the block: 1.96x the useful rows
//     at 28^2 -> 20^2, but x is read once for up to 8 taps instead of once
//     a tap.  B is four TMA boxes of 64 rows x 128 bytes.  For Co <= 32 a
//     box holds two taps whose row shifts differ by one (neighbours in the
//     last kernel dim): a first kernel lays g out as gpair[r] = [gcan[r -
//     1], gcan[r]] (channels padded to 32) in the workspace, so one box
//     row at r = p - off(t) holds tap t + 1's and tap t's rows (a 64-byte
//     box a tap doubled the copy requests, and they set the pace); else
//     gcan padded to 64 channels, a tap a box.  TMA fills zeros before and past the
//     canvas.  The wrapper's box table lists each block's taps
//     (tapconv.dw_plan): at the 9 x 9 act conv 45 boxes, 12 tap groups.
//     The canvas rows split into S groups whose f32 partials (S, taps,
//     Ci, Co) tap_conv_dw_reduce sums in a fixed order (no atomics).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

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

// ------------------------------------------------------- f32 K3, K4, K5

constexpr int VEC = 4;  // floats a 16-byte copy
constexpr int BK = 16;  // reduction depth a step
static_assert(BK / VEC == 4, "four 16-byte copies a row of BK");

template <int MODE, int BN>
struct Cfg {
  static constexpr int PAD = VEC;                  // 16 bytes a smem row
  static constexpr bool A_COL = MODE == DW;        // A stored [BK][BM]
  static constexpr bool B_COL = MODE == DX;        // B stored [BN][BK]
  static constexpr int LDA = A_COL ? BM + PAD : BK + PAD;
  static constexpr int LDB = B_COL ? BK + PAD : BN + PAD;
  static constexpr int A_ELEMS = A_COL ? BK * LDA : BM * LDA;
  static constexpr int B_ELEMS = B_COL ? BN * LDB : BK * LDB;
  static constexpr int STAGE_BYTES = (A_ELEMS + B_ELEMS) * 4;
  static_assert((A_ELEMS * 4) % 128 == 0 && STAGE_BYTES % 128 == 0,
                "tiles keep 128-byte alignment");
  static_assert(2 * STAGE_BYTES <= 48 * 1024, "static shared memory");
};

// Stage step s's A and B tiles (zeros outside the operands).  a_row[q]:
// for K3 the canvas row of this thread's output row q (-1 past the end),
// for K4 its canvas row p (-1 past the end).
template <int MODE, int BN>
__device__ __forceinline__ void load_step(float* As, float* Bs, const float* __restrict__ a,
                                          const float* __restrict__ b, const Geo& g, int s,
                                          int m0, int n0, int tap, const int a_row[2]) {
  using C = Cfg<MODE, BN>;
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

template <int MODE, int BN>
__device__ __forceinline__ void tap_gemm(const float* __restrict__ a, const float* __restrict__ b,
                                         float* __restrict__ out, const Geo& g) {
  using C = Cfg<MODE, BN>;
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
  auto stage_a = [&](int st) { return reinterpret_cast<float*>(smem + st * C::STAGE_BYTES); };
  auto stage_b = [&](int st) { return stage_a(st) + C::A_ELEMS; };

  constexpr int THREADS_N = BN >= 64 ? 16 : 8, THREADS_M = NTHREADS / THREADS_N;
  constexpr int TN = BN / THREADS_N, TM = BM / THREADS_M;
  const int tn = tid % THREADS_N, tm = tid / THREADS_N;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (nsteps > 0) load_step<MODE, BN>(stage_a(0), stage_b(0), a, b, g, 0, m0, n0, tap, a_row);
  cp_async_commit();
  for (int s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps)
      load_step<MODE, BN>(stage_a((s + 1) & 1), stage_b((s + 1) & 1), a, b, g, s + 1, m0, n0,
                          tap, a_row);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* As = stage_a(s & 1);
    const float* Bs = stage_b(s & 1);
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

template <int BN>
__global__ void __launch_bounds__(NTHREADS)
tap_conv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out, Geo g) {
  tap_gemm<FWD, BN>(x, w, out, g);
}

template <int BN>
__global__ void __launch_bounds__(NTHREADS)
tap_conv_dx_kernel(const float* __restrict__ gcan, const float* __restrict__ w,
                   float* __restrict__ dx, Geo g) {
  tap_gemm<DX, BN>(gcan, w, dx, g);
}

template <int BN>
__global__ void __launch_bounds__(NTHREADS)
tap_conv_dw_kernel(const float* __restrict__ x, const float* __restrict__ gout,
                   float* __restrict__ dw, Geo g) {
  tap_gemm<DW, BN>(x, gout, dw, g);
}

template <int BN>
int launch(int mode, const void* a, const void* b, void* out, const Geo& g, cudaStream_t st) {
  const int M = mode == FWD ? g.Mv : (mode == DX ? g.Mc : g.Ci);
  const int N = mode == DX ? g.Ci : g.Co;
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, mode == DW ? g.ntaps : 1);
  const float* ta = static_cast<const float*>(a);
  const float* tb = static_cast<const float*>(b);
  float* to = static_cast<float*>(out);
  if (mode == FWD) tap_conv_fwd_kernel<BN><<<grid, NTHREADS, 0, st>>>(ta, tb, to, g);
  else if (mode == DX) tap_conv_dx_kernel<BN><<<grid, NTHREADS, 0, st>>>(ta, tb, to, g);
  else tap_conv_dw_kernel<BN><<<grid, NTHREADS, 0, st>>>(ta, tb, to, g);
  return (int)cudaGetLastError();
}

// the f32 body at the caller's tile, bm x bn with reduction steps of bk:
// one of those it is built for, or cudaErrorInvalidValue
int launch_f32(int mode, int bm, int bn, int bk, const void* a, const void* b, void* out,
               const Geo& g, cudaStream_t st) {
  if (bm == BM && bk == BK) {
    if (bn == 128) return launch<128>(mode, a, b, out, g, st);
    if (bn == 32) return launch<32>(mode, a, b, out, g, st);
  }
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------- bf16 K3 and K4 on wgmma

constexpr int HBK = 64;  // reduction depth a step: one 128-byte row of bf16

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
      wgmma<BN, 0, MODE == FWD ? 1 : 0>(acc, da, db);
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

// ------------------------------------------------------------ bf16 K5 on wgmma

constexpr int DW_BN = 256;             // bf16 K5's N tile
constexpr int DW_BOXES = DW_BN / 64;   // B boxes a step, 64 columns (128 bytes) each
constexpr int DW_CANVAS_CO = 64;       // the canvas form's widest Co (tapconv._DW_CANVAS_CO)
constexpr int DW_PAIR_CO = 32;         // up to this Co a canvas box holds two taps
constexpr int DW_TABLE = 1 + 2 * DW_BOXES;  // a row of the box table (tapconv.dw_plan)

// One block: dW rows [m0, m0 + 128) of Ci x 256 columns.  A is M-major:
// row k of a stage holds the step's position k, Ci [m0 + 64 j, + 64) in
// the 8 KB block j that warpgroup j multiplies.  B is N-major, up to four
// boxes of 64 rows x 64 columns in the 128-byte swizzle.
//   CANVAS = false (the valid-row form): columns [n0, n0 + 256) of Co and
//     tap blockIdx.z, summed over every valid output position; A rows
//     gathered by cp.async, B boxes of gmap = g as (Mv, Co).
//   CANVAS = true: the boxes of row blockIdx.y of `boxes` ([count, base
//     tap, second tap or -1, ...]), summed over the canvas rows of split z
//     = blockIdx.z (steps [z * per, ...)); A boxes of xmap = x as (Mc,
//     Ci); box u takes gmap's rows p - off(base tap), where gmap is, for
//     Co <= 32, gpair (Mc + 1, 64) with gpair[r] = [gcan[r - 1], gcan[r]]
//     (channels padded to 32): the second tap (off + 1) in columns 0-31,
//     the base tap in 32-63; else gcan padded to 64 channels, one tap.
//     With ws, the split's f32 partials go to ws[z] (taps, Ci, Co).
template <bool CANVAS>
__global__ void __launch_bounds__(256)
tap_conv_dw_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                         const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap gmap, float* __restrict__ dw,
                         float* __restrict__ ws, const int* __restrict__ boxes,
                         int steps_per_split, Geo g) {
  using C = HCfg<DW, 2, DW_BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.x * C::BM;
  const bool live = m0 + wg * 64 < g.Ci;  // this warpgroup's Ci rows exist
  int n0 = 0, s0 = 0, nsteps, nbox;
  int tb[DW_BOXES], th[DW_BOXES], off[DW_BOXES];  // each box's taps and row shift
  if constexpr (CANVAS) {
    const int* row = boxes + static_cast<size_t>(blockIdx.y) * DW_TABLE;
    nbox = row[0];
#pragma unroll
    for (int u = 0; u < DW_BOXES; ++u) {
      tb[u] = u < nbox ? row[1 + 2 * u] : -1;
      th[u] = u < nbox ? row[2 + 2 * u] : -1;
      off[u] = tb[u] >= 0 ? tap_offset(g, tb[u]) : 0;
    }
    s0 = blockIdx.z * steps_per_split;
    nsteps = max(0, min((g.Mc + HBK - 1) / HBK - s0, steps_per_split));
  } else {
    n0 = blockIdx.y * DW_BN;
    nbox = min(DW_BOXES, (g.Co - n0 + 63) / 64);  // boxes with columns inside Co
#pragma unroll
    for (int u = 0; u < DW_BOXES; ++u) {
      tb[u] = blockIdx.z;
      th[u] = -1;
      off[u] = tap_offset(g, blockIdx.z);
    }
    nsteps = (g.Mv + HBK - 1) / HBK;
  }
  const int arow = tid >> 2;  // valid-row form: the A row this thread copies
  const uint32_t bars = smem_addr(smem + C::NS * C::STAGE);  // mbarrier of stage i: bars + 8 i
  if (tid == 0) {
    for (int i = 0; i < C::NS; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load = [&](int s, int buf) {
    unsigned char* As = smem + buf * C::STAGE;
    const uint32_t a_s = smem_addr(As), b_s = a_s + C::A_BYTES;
    const int r0 = (s0 + s) * HBK;  // the step's first position
    if constexpr (!CANVAS) {  // x[base(r0 + arow) + off, m0 + 8c : + 8] -> chunk c of the row
      const int m = r0 + arow;
      const int src = m < g.Mv ? out_base(g, m) + off[0] : -1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = (tid & 3) + 4 * j, ci = m0 + 8 * c;
        const bool ok = src >= 0 && ci < g.Ci;
        cp_async16(As + (c >> 3) * 8192 + sw128(arow, c & 7),
                   ok ? x + static_cast<size_t>(src) * g.Ci + ci : x, ok);
      }
    }
    if (tid == 0) {
      const uint32_t bar = bars + 8 * buf;
      const int na = CANVAS ? (m0 + 64 < g.Ci ? 2 : 1) : 0;  // A boxes with Ci rows inside x
      mbar_expect_tx(bar, (na + nbox) * 8192);
      for (int j = 0; j < na; ++j) tma_load_2d(a_s + j * 8192, &xmap, m0 + 64 * j, r0, bar);
#pragma unroll
      for (int u = 0; u < DW_BOXES; ++u)
        if (u < nbox)
          tma_load_2d(b_s + u * 8192, &gmap, CANVAS ? 0 : n0 + 64 * u, CANVAS ? r0 - off[u] : r0,
                      bar);
    }
  };

  float acc[DW_BN / 2];
#pragma unroll
  for (int i = 0; i < DW_BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < C::AHEAD; ++i) {
    if (i < nsteps) load(i, i);
    cp_async_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    // as in tap_conv_wgmma: step s has landed, and step s - 2's wgmma has
    // finished in every warpgroup, so its stage takes step s + AHEAD
    cp_async_wait<C::AHEAD - 1>();
    mbar_wait(bars + 8 * (s % C::NS), (s / C::NS) & 1);
    fence_proxy_async();
    __syncthreads();
    if (s + C::AHEAD < nsteps) load(s + C::AHEAD, (s + C::AHEAD) % C::NS);
    cp_async_commit();
    if (live) {
      const uint32_t a_addr = smem_addr(smem + (s % C::NS) * C::STAGE) + wg * 8192;
      const uint32_t b_addr = smem_addr(smem + (s % C::NS) * C::STAGE + C::A_BYTES);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HBK / 16; ++kk)  // a k16 step: 16 rows of 128 bytes, 2 KB
        wgmma<DW_BN, 1, 1>(acc, sw128_desc(a_addr + kk * 2048, 8192, 1024),
                           sw128_desc(b_addr + kk * 2048, 8192, 1024));
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(acc);
    }
  }
  cp_async_wait<0>();
  if (!live) return;
  wgmma_wait<0>();
  fence_acc(acc);

  // the accumulator layout of tap_conv_wgmma's epilogue; column col is
  // column col % 64 of box col / 64
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int row0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const bool pair = g.Co <= DW_PAIR_CO;
  float* out = ws ? ws + static_cast<size_t>(blockIdx.z) * g.ntaps * g.Ci * g.Co : dw;
#pragma unroll
  for (int i = 0; i < DW_BN / 2; i += 2) {
    const int row = row0 + ((i >> 1) & 1) * 8;
    const int col = (i >> 2) * 8 + (lane & 3) * 2;
    const int u = col >> 6, c = col & 63;
    int tap = tb[u], co = n0 + col;
    if constexpr (CANVAS) {
      if (pair && c < 32) tap = th[u];
      co = pair ? c & 31 : c;
    }
    if (u < nbox && tap >= 0 && row < g.Ci && co < g.Co)
      *reinterpret_cast<float2*>(out + (static_cast<size_t>(tap) * g.Ci + row) * g.Co + co) =
          make_float2(acc[i], acc[i + 1]);
  }
}

// The canvas form's B matrix gb (rows, 64) from g, in one pass: for Co <=
// 32, rows = Mc + 1 and gb[r] = [gcan[r - 1], gcan[r]] (each padded to 32
// channels); else rows = Mc and gb[r] = gcan[r] padded to 64 channels.
// gcan[q] is g at the valid output position of canvas row q, zero at
// every other row.  A thread writes 8 columns (16 bytes) of a row.
__global__ void tap_conv_dw_operand_kernel(const __nv_bfloat16* __restrict__ g,
                                           __nv_bfloat16* __restrict__ gb, int rows, Geo geo) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * 8) return;
  const int r = i >> 3, c8 = (i & 7) * 8;
  const bool pair = geo.Co <= DW_PAIR_CO;
  const int q = pair && c8 < 32 ? r - 1 : r;  // the gcan row, and its channel:
  const int ch = pair ? c8 & 31 : c8;
  uint4 v = make_uint4(0, 0, 0, 0);
  if (q >= 0 && q < geo.Mc && ch < geo.Co) {
    const int b = q / geo.cs;
    int rem = q - b * geo.cs;
    const int i0 = rem / geo.st[0];
    rem -= i0 * geo.st[0];
    const int i1 = rem / geo.st[1], i2 = rem - i1 * geo.st[1];
    if (i0 < geo.o[0] && i1 < geo.o[1] && i2 < geo.o[2]) {
      const int m = b * geo.os + (i0 * geo.o[1] + i1) * geo.o[2] + i2;
      v = *reinterpret_cast<const uint4*>(g + static_cast<size_t>(m) * geo.Co + ch);
    }
  }
  *reinterpret_cast<uint4*>(gb + static_cast<size_t>(r) * 64 + c8) = v;
}

// ------------------------------------------ the split kernels' second pass

__device__ __forceinline__ void store4(__nv_bfloat16* out, size_t i, float4 v) {
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out) + 2 * i;
  o[0] = __floats2bfloat162_rn(v.x, v.y);
  o[1] = __floats2bfloat162_rn(v.z, v.w);
}
__device__ __forceinline__ void store4(float* out, size_t i, float4 v) {
  reinterpret_cast<float4*>(out)[i] = v;
}

// out = the sum of the S f32 partials ws[0], ..., ws[S - 1], in that order
template <typename OutT>
__device__ __forceinline__ void split_reduce(const float4* __restrict__ ws, OutT* __restrict__ out,
                                             int splits, size_t n4) {
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
    store4(out, i, v);
  }
}

// K3's, in x's type
__global__ void tap_conv_fwd_reduce_kernel(const float4* __restrict__ ws,
                                           __nv_bfloat16* __restrict__ out, int splits,
                                           size_t n4) {
  split_reduce(ws, out, splits, n4);
}

// K5's, in f32
__global__ void tap_conv_dw_reduce_kernel(const float4* __restrict__ ws, float* __restrict__ out,
                                          int splits, size_t n4) {
  split_reduce(ws, out, splits, n4);
}

template <typename OutT>
void launch_split_reduce(void (*kern)(const float4*, OutT*, int, size_t), const float* ws,
                         OutT* out, int splits, size_t n, cudaStream_t st) {
  const size_t n4 = n / 4;
  const int blocks = static_cast<int>((n4 + 255) / 256 < 4096 ? (n4 + 255) / 256 : 4096);
  kern<<<blocks, 256, 0, st>>>(reinterpret_cast<const float4*>(ws), out, splits, n4);
}

template <typename Kern>
int set_smem(Kern kern, int bytes) {
  static_assert(std::is_pointer<Kern>::value, "a kernel");
  return static_cast<int>(
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// a row-major (rows, cols) bf16 matrix as a TMA map: boxes of box_cols (64)
// x box_rows in the 128-byte swizzle, zeros outside the matrix
int tensor_map_2d(CUtensorMap* map, const void* p, int rows, int cols, int box_cols,
                  int box_rows) {
  const long long dims[2] = {cols, rows};
  const int box[2] = {box_cols, box_rows};
  return tensor_map_bf16(map, p, 2, dims, box);
}

// W as the 2-D (ntaps * Ci, Co) matrix, boxes of 64 columns x box_rows
// rows in the 128-byte swizzle
int w_tensor_map(CUtensorMap* map, const void* w, const Geo& g, int box_rows) {
  return tensor_map_2d(map, w, g.ntaps * g.Ci, g.Co, 64, box_rows);
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
  if (splits > 1)
    launch_split_reduce(tap_conv_fwd_reduce_kernel, ws, o, splits,
                        static_cast<size_t>(g.Mv) * g.Co, st);
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

// bf16 K5 (b = g): groups 0 the valid-row form, else the canvas form with
// `groups` rows of the box table `boxes` and the canvas rows in `splits`
// groups; its workspace ws holds the B matrix (tap_conv_dw_operand_kernel)
// and, 256 bytes aligned after it, the splits' f32 partials
int launch_dw_wgmma(const void* x, const void* b, float* dw, const int* boxes, int groups,
                    void* ws, int splits, const Geo& g, cudaStream_t st) {
  using C = HCfg<DW, 2, DW_BN>;
  const bool canvas = groups > 0;
  const int rows = canvas ? g.Mc : g.Mv;  // the reduction's positions
  const int steps = (rows + HBK - 1) / HBK;
  if (canvas ? g.Co > DW_CANVAS_CO || !boxes || !ws || splits < 1 || (steps > 0 && splits > steps)
             : splits != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0)  // no position: dW is zero
    return static_cast<int>(
        cudaMemsetAsync(dw, 0, sizeof(float) * g.ntaps * g.Ci * g.Co, st));
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const void* bmat = b;
  float* part = nullptr;
  CUtensorMap xmap = {}, gmap;
  if (canvas) {
    const int b_rows = g.Co <= DW_PAIR_CO ? g.Mc + 1 : g.Mc;
    auto* gb = static_cast<__nv_bfloat16*>(ws);
    tap_conv_dw_operand_kernel<<<(b_rows * 8 + 255) / 256, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(b), gb, b_rows, g);
    bmat = gb;
    part = reinterpret_cast<float*>(static_cast<char*>(ws) +
                                    (static_cast<size_t>(b_rows) * 128 + 255) / 256 * 256);
    if (const int err = tensor_map_2d(&xmap, x, g.Mc, g.Ci, 64, HBK))
      return err;
    if (const int err =
            tensor_map_2d(&gmap, bmat, b_rows, 64, 64, HBK))
      return err;
  } else if (const int err =
                 tensor_map_2d(&gmap, b, g.Mv, g.Co, 64, HBK)) {
    return err;
  }
  auto kern = canvas ? tap_conv_dw_wgmma_kernel<true> : tap_conv_dw_wgmma_kernel<false>;
  if (const int err = set_smem(kern, C::SMEM)) return err;
  const int per = (steps + splits - 1) / splits;
  const int ci_tiles = (g.Ci + C::BM - 1) / C::BM;
  const dim3 grid = canvas ? dim3(ci_tiles, groups, splits)
                           : dim3(ci_tiles, (g.Co + DW_BN - 1) / DW_BN, g.ntaps);
  kern<<<grid, C::THREADS, C::SMEM, st>>>(xb, xmap, gmap, dw, splits > 1 ? part : nullptr,
                                          boxes, per, g);
  if (splits > 1)
    launch_split_reduce(tap_conv_dw_reduce_kernel, part, dw, splits,
                        static_cast<size_t>(g.ntaps) * g.Ci * g.Co, st);
  return static_cast<int>(cudaGetLastError());
}

// bf16 K3, K4 and K5 at the caller's tile (K4's tap table has a row for
// each bm canvas rows): one of those the bodies are built for, or
// cudaErrorInvalidValue
int launch_wgmma(int mode, int bm, int bn, int bk, const void* a, const void* b, void* out,
                 const int* taps, int tap_stride, void* ws, int splits, int groups,
                 const Geo& g, cudaStream_t st) {
  if (bk == HBK && mode == DW && bm == 128 && bn == DW_BN && (!groups || tap_stride == DW_TABLE))
    return g.Ci == 0 || g.Co == 0
               ? 0
               : launch_dw_wgmma(a, b, static_cast<float*>(out), taps, groups, ws, splits, g, st);
  const bool empty = mode == FWD ? g.Mv == 0 || g.Co == 0 : g.Mc == 0 || g.Ci == 0;
  if (bk == HBK && mode == FWD) {
    float* part = static_cast<float*>(ws);
    if (bm == 64 && bn == 64) return empty ? 0 : launch_fwd_wgmma<1, 64>(a, b, out, part, splits, g, st);
    if (bm == 128 && bn == 256)
      return empty ? 0 : launch_fwd_wgmma<2, 256>(a, b, out, part, splits, g, st);
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
// (tapconv.dx_tap_table).  bf16 K3 with splits > 1 takes `ws`, f32
// (splits, B * prod(o), Co), and splits no larger than its steps
// (ceil(prod(k) * Ci / bk)).  bf16 K5 follows tapconv.dw_plan: groups 0
// is the valid-row form (splits 1); groups > 0 the canvas form (Co <= 64),
// whose `taps` is the box table, int32 (groups, tap_stride = 9), row i =
// [count <= 4, base tap, second tap or -1, ...], with splits no larger
// than its steps (ceil(B * prod(s) / bk)) and the workspace `ws`: its B
// matrix, bf16 (B * prod(s) + (Co <= 32), 64), then 256-byte aligned the
// f32 partials (splits, *k, Ci, Co) when splits > 1
// (tapconv.dw_workspace_bytes); split group z takes steps [z * per, (z +
// 1) * per) with per = ceil(steps / splits).  Other modes and types
// ignore taps, ws, splits and groups.  Launches on `stream`, does not
// synchronise, and returns the CUDA error (0 on success).
extern "C" int picad_tap_conv(int mode, const void* a, const void* b, void* out, int B,
                              int Ci, int Co, int s0, int s1, int s2, int k0, int k1, int k2,
                              int is_bf16, int bm, int bn, int bk, const int* taps,
                              int tap_stride, void* ws, int splits, int groups, void* stream) {
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
  if (!is_bf16) return launch_f32(mode, bm, bn, bk, a, b, out, g, st);
  return launch_wgmma(mode, bm, bn, bk, a, b, out, taps, tap_stride, ws, splits, groups, g, st);
}
