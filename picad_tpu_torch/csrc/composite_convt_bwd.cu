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
// g is rounded to x's type (the JAX package rounds it first,
// pallas_fused_head.py:463); every product is exact and summed in f32.
// As on the TPU, G never exists in device memory: at the train shape
// (16, 4, 112, 112, 125) it would be 205 MB in bf16.
//
// Bound on an H100 SXM at the train shape B = 16, x (16, 4, 112, 112,
// 128) bf16: x read 205.5 MB, g read 12.8 MB (in bf16), dx written 205.5
// MB, about 425 MB in all, is 0.127 ms at 3.35 TB/s, against 51.4 GFLOP
// of useful work, 0.052 ms on the bf16 tensor cores (0.77 ms on the FP32
// cores): bound by bytes once the products are on the tensor cores.
//
// bf16: the TPU kernel's structure with tiles sized for an SM
// (composite_bwd_wgmma_kernel): one G tile in shared memory feeds both
// GEMMs.  A tile is 128 consecutive w at a fixed (b, t, h); G[tau, p] for
// its 125 taps (padded to 128 with zero rows) x 128 positions is 32 KB of
// bf16, laid out taps-major (two 16 KB blocks of 64 positions, rows of 128
// bytes in the 128-byte swizzle).  With tau = 2m + rho per axis, a row of
// G is a w-shifted run of one phase plane of g: G[tau, p] =
// gphase_rho[w0 + p - 1 + m] (fused_head_kernel.bwd_tap_table).  The block
// keeps, for its 5 g frames 2t - 2 .. 2t + 2, a ring of 8 g rows split by
// column parity (bf16, 23 KB), reads f32 g straight into it (rounded
// there: no separate cast launch), and builds G from it: each 16-byte
// chunk of a ring row (tau_t, tau_h, rho) gives its 3 (rho 0) or 2 (rho 1)
// G rows tau_w = 2m + rho, shifted by m elements with a byte permute.
// Tiles run h fastest, so the next tile of a block needs 2 new g rows a
// frame, not 5; those are loaded into registers a tile ahead.
//   dx  (M = 128 positions, N = 128 channels, K = 128 taps): A = G read
//       M-major (wgmma's A-transpose flag), B = Kc (taps x channels,
//       N-major) resident for the block (one 3-D TMA map, rows 125-127 and
//       channels past C read as zeros); rows p with w >= W are not written.
//   dKc (M = 128 taps, N = 128 channels, K = 128 positions): A = the same
//       G tile K-major, B = the x tile (two TMA boxes of 64 channels x 128
//       positions, x described as (C, W, H, T, B) so that w >= W reads as
//       zeros: G is not zero there), accumulated in registers over all the
//       block's tiles.
// Two warpgroups (64 positions, and 64 taps, each); 64 + 64 f32 a thread.
// G and x are double-buffered: x(q + 1) is in flight by TMA and G(q + 1)
// is built while tile q's wgmma run (the build, not the tensor cores,
// sets the pace), and dx leaves by TMA stores from a staging buffer.  A block walks a contiguous range of
// one sample's tiles (the split S of fused_head_kernel.bwd_plan fills the
// card's SMs) and 128 channels; it writes one f32 dKc partial, and a
// second kernel sums a sample's partials in split order: no atomics, the
// same bits on every run.
//
// f32: the FP32-core body (composite_bwd_kernel), full f32, never TF32.
// Input-stationary: one block owns (b, a 16 x 16 tile of (h, w)) and walks
// every frame t and every 32-channel chunk, staging the parity-split g
// window (frames 2t-2 .. 2t+2, rows 2h0-2 .. 2h0+32, columns 2w0-2 ..
// 2w0+32), the tile's x and Kc's 125 x 32 slice as f32; thread p
// accumulates dx for its position over the 125 taps (Kc reads are warp
// broadcasts), thread (4 taps, 4 channels) its dKc entries over the
// tile's positions and all t, then writes a per-block partial that
// reduce_partials sums in tile order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

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

__device__ __forceinline__ void load8(const float* src, float* v) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__global__ void __launch_bounds__(NTHREADS)
composite_bwd_kernel(const float* __restrict__ g, const float* __restrict__ x,
                     const float* __restrict__ kc, float* __restrict__ dx,
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

  const float* gb = g + (size_t)b * T2 * H2 * W2;
  const float* xb = x + (size_t)b * T * H * W * C;
  const float* kb = kc + (size_t)b * NTAPS * C;
  float* dxb = dx + (size_t)b * T * H * W * C;
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
          v = gb[((size_t)gf * H2 + gr) * W2 + gc];
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
        float* dst = dxb + (((size_t)t * H + h0 + ph) * W + w0 + pw) * C + c0;
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

int launch(const void* g, const void* x, const void* kc, void* dx, void* partial,
           void* dkc, int B, int T, int H, int W, int C, cudaStream_t stream) {
  // above 48 KB, dynamic shared memory must be opted into; the setting
  // belongs to the current device, so it is made on every launch
  const cudaError_t attr = cudaFuncSetAttribute(
      composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  composite_bwd_kernel<<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      static_cast<const float*>(g), static_cast<const float*>(x),
      static_cast<const float*>(kc), static_cast<float*>(dx),
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


// ------------------------------------------------------------- bf16 on wgmma

constexpr int BW_P = 128;                        // positions (w) a tile
constexpr int BW_C = 128;                        // channels a block
constexpr int BW_THREADS = 256;                  // two warpgroups
constexpr int BW_GPW = 144;                      // a phase row of the g ring (bf16): 136 read
constexpr int BW_RING = 8;                       // g rows a frame keeps: a tile needs 5
constexpr int BW_G = 128 * BW_P * 2;             // 32 KB: G, two blocks of 64 positions
constexpr int BW_K = 128 * BW_C * 2;             // 32 KB: Kc, two boxes of 64 channels
constexpr int BW_X = BW_P * BW_C * 2;            // 32 KB: an x tile, two boxes of 64 channels
constexpr int BW_RING_BYTES = 5 * BW_RING * 2 * BW_GPW * 2;
constexpr int BW_SMEM = 1024 + 2 * BW_G + BW_K + 3 * BW_X + BW_RING_BYTES + 8 * 3;
// g loads a thread keeps in flight: a continuing tile's new ring rows (5
// frames x 2 rows x 136 column pairs), loaded one tile ahead; a tile that
// starts a run loads its 5 rows a frame in batches of as many
constexpr int BW_PF = 6;
constexpr int BW_LOADS = (5 * 5 * 136 + BW_THREADS - 1) / BW_THREADS;
static_assert(BW_PF * BW_THREADS >= 5 * 2 * 136, "one batch holds a continuing tile's rows");
static_assert(BW_RING_BYTES % 16 == 0 && (BW_GPW * 2) % 16 == 0, "16-byte ring rows");
static_assert(BW_SMEM <= 232448, "shared memory");

// One block: tiles [q0, q0 + per) of sample b = blockIdx.z (tile q = (t *
// nwt + wt) * H + h: 128 positions from w0 = 128 wt of row (t, h)),
// channels [c0, c0 + 128) with c0 = 128 blockIdx.y.  g (B, 2T, 2H, 2W)
// f32; xmap and dxmap: x and dx as (C, W, H, T, B), boxes (64, 128, 1, 1,
// 1); kmap: Kc as (C, 125, B), boxes (64, 128, 1).  Writes dx's tiles (by
// TMA stores, which drop the rows past W and the channels past C) and the
// block's dKc partial, partial[b, blockIdx.x] (125, C) f32.
__global__ void __launch_bounds__(BW_THREADS, 1)
composite_bwd_wgmma_kernel(const float* __restrict__ g, const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap dxmap,
                           float* __restrict__ partial, int T, int H, int W, int C, int nwt,
                           int per) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* gs = smem;                      // G buffers [2][2 blocks][128 taps][128 B]
  unsigned char* ks = gs + 2 * BW_G;             // Kc [2 boxes][128 taps][128 B]
  unsigned char* xs = ks + BW_K;                 // x buffers [2][2 boxes][128 positions][128 B]
  unsigned char* ds = xs + 2 * BW_X;             // dx staging, x's layout
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(ds + BW_X);  // [5][8][2][GPW]
  const uint32_t bars = smem_addr(ds + BW_X + BW_RING_BYTES);  // x buffers: + 0, 8; Kc: + 16

  const int tid = threadIdx.x, wg = tid >> 7;
  const int c0 = blockIdx.y * BW_C, b = blockIdx.z;
  const int ntiles = T * nwt * H;
  const int q0 = blockIdx.x * per, q1 = min(ntiles, q0 + per);
  const int T2 = 2 * T, H2 = 2 * H, W2 = 2 * W;
  const float* gb = g + static_cast<size_t>(b) * T2 * H2 * W2;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // G's rows 125-127 are zero in both buffers, once; with C - c0 <= 64 the
  // second 64-channel box of Kc and of both x buffers is never loaded and
  // stays zero
  const int nbox = C - c0 > 64 ? 2 : 1;
  for (int e = tid; e < 2 * 2 * 3 * 8; e += BW_THREADS)
    *reinterpret_cast<uint4*>(gs + (e / 24) * 16384 + sw128(125 + (e / 8) % 3, e % 8)) =
        make_uint4(0, 0, 0, 0);
  if (nbox == 1)
    for (int e = tid; e < 3 * 1024; e += BW_THREADS)  // 16 KB at Kc + 16 KB, x0 + 16 KB, x1 + 16 KB
      reinterpret_cast<uint4*>(ks + 16384 + (e >> 10) * BW_X)[e & 1023] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  auto decode = [&](int q, int& t, int& w0, int& h) {
    h = q % H;
    const int r = q / H;
    t = r / nwt;
    w0 = (r - t * nwt) * BW_P;
  };
  auto load_x = [&](int q, int buf) {  // thread 0: tile q's x into buffer buf
    int t, w0, h;
    decode(q, t, w0, h);
    const uint32_t bar = bars + 8 * buf, dst = smem_addr(xs + buf * BW_X);
    mbar_expect_tx(bar, nbox * 16384);
    for (int j = 0; j < nbox; ++j) tma_load_5d(dst + j * 16384, &xmap, c0 + 64 * j, w0, h, t, b, bar);
  };
  // the ring rows th in [5 - NROW, 5) of tile q, items e = tid + (k0 + k) *
  // BW_THREADS of (frame tt, row, column pair i): gload reads them from g
  // into registers, gstore rounds them into the ring
  auto gload = [&](auto nrow, int q, int k0, float2 (&v)[BW_PF]) {
    constexpr int NROW = decltype(nrow)::value;
    int t, w0, h;
    decode(q, t, w0, h);
#pragma unroll
    for (int k = 0; k < BW_PF; ++k) {
      const int e = tid + (k0 + k) * BW_THREADS;
      const int i = e % 136, rr = e / 136;
      const int tt = rr / NROW, th = 5 - NROW + rr % NROW;
      const int f = 2 * t - 2 + tt, r = 2 * h - 2 + th, col = 2 * (w0 - 1 + i);
      v[k] = make_float2(0.f, 0.f);  // (column parity 0, 1)
      if (e < 5 * NROW * 136 && f >= 0 && f < T2 && r >= 0 && r < H2 && col >= 0 && col < W2)
        v[k] = __ldg(reinterpret_cast<const float2*>(gb + (static_cast<size_t>(f) * H2 + r) * W2 +
                                                     col));
    }
  };
  auto gstore = [&](auto nrow, int q, int k0, const float2 (&v)[BW_PF]) {
    constexpr int NROW = decltype(nrow)::value;
    const int h = q % H;
#pragma unroll
    for (int k = 0; k < BW_PF; ++k) {
      const int e = tid + (k0 + k) * BW_THREADS;
      if (e >= 5 * NROW * 136) break;
      const int i = e % 136, rr = e / 136;
      const int tt = rr / NROW, r = 2 * h + 3 - NROW + rr % NROW;  // th = 5 - NROW + rr % NROW
      __nv_bfloat16* dst = ring + ((tt * BW_RING + ((r + 8) & 7)) * 2) * BW_GPW + i;
      dst[0] = __float2bfloat16_rn(v[k].x);
      dst[BW_GPW] = __float2bfloat16_rn(v[k].y);
    }
  };
  constexpr std::integral_constant<int, 2> next2{};  // a continuing tile: 2 new rows a frame
  constexpr std::integral_constant<int, 5> all5{};   // a tile that starts a run: all 5
  // the ring holds tile q - 1's rows: tile q lacks 2 a frame
  auto cont = [&](int q) { return q > q0 && q % H > 0; };
  // G of tile q into buffer buf: first the g rows it lacks into the ring
  // (2 a frame, loaded one tile ahead into pf, or all 5, loaded here), then
  // the next tile's 2 rows a frame into pf, then the G rows: a thread takes
  // 8 positions (16 bytes) of one ring row (frame tt, row th, parity rho)
  // and writes the 3 (rho 0) or 2 (rho 1) tap rows tau_w = 2m + rho it
  // gives, shifted by m
  auto build = [&](int q, int buf, float2 (&pf)[BW_PF]) {
    const int h = q % H;
    if (cont(q)) {
      gstore(next2, q, 0, pf);
    } else {
      for (int k0 = 0; k0 < BW_LOADS; k0 += BW_PF) {
        float2 v[BW_PF];
        gload(all5, q, k0, v);
        gstore(all5, q, k0, v);
      }
    }
    if (q + 1 < q1 && cont(q + 1)) gload(next2, q + 1, 0, pf);
    __syncthreads();
    unsigned char* G = gs + buf * BW_G;
    for (int e = tid; e < 50 * 16; e += BW_THREADS) {
      const int row = e >> 4, c = e & 15;  // ring row (tt, th, rho); positions 8c .. 8c + 7
      const int tt = row / 10, th = (row >> 1) % 5, rho = row & 1;
      const __nv_bfloat16* src =
          ring + ((tt * BW_RING + ((2 * h + 6 + th) & 7)) * 2 + rho) * BW_GPW + 8 * c;
      // G[tau, 8c + k] = ring row [8c + k + m]: 8 bf16 of a 16-byte aligned
      // pair, shifted by m elements
      const uint4 lo = *reinterpret_cast<const uint4*>(src);
      const uint4 hi = *reinterpret_cast<const uint4*>(src + 8);
      unsigned char* g0 = G + (c >> 3) * 16384;
      const int tau = tt * 25 + th * 5 + rho;  // m = 0
      *reinterpret_cast<uint4*>(g0 + sw128(tau, c & 7)) = lo;
      *reinterpret_cast<uint4*>(g0 + sw128(tau + 2, c & 7)) =
          make_uint4(__byte_perm(lo.x, lo.y, 0x5432), __byte_perm(lo.y, lo.z, 0x5432),
                     __byte_perm(lo.z, lo.w, 0x5432), __byte_perm(lo.w, hi.x, 0x5432));
      if (rho == 0)
        *reinterpret_cast<uint4*>(g0 + sw128(tau + 4, c & 7)) = make_uint4(lo.y, lo.z, lo.w, hi.x);
    }
    fence_proxy_async();  // G's generic-proxy writes, before wgmma reads them
  };

  if (tid == 0 && q0 < q1) {
    mbar_expect_tx(bars + 16, nbox * 16384);
    for (int j = 0; j < nbox; ++j)
      tma_load_3d(smem_addr(ks) + j * 16384, &kmap, c0 + 64 * j, 0, b, bars + 16);
    load_x(q0, 0);
    if (q0 + 1 < q1) load_x(q0 + 1, 1);
  }
  float2 pf[BW_PF];
  if (q0 < q1) build(q0, 0, pf);
  __syncthreads();

  float dacc[64], kacc[64];  // dacc: each tile's first product writes it
#pragma unroll
  for (int i = 0; i < 64; ++i) dacc[i] = kacc[i] = 0.f;
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int arow = wg * 64 + warp * 16 + (lane >> 2);  // accumulator row of element 0
  if (q0 < q1) mbar_wait(bars + 16, 0);
  for (int q = q0, i = 0; q < q1; ++q, ++i) {
    const int buf = i & 1;
    mbar_wait(bars + 8 * buf, (i >> 1) & 1);
    const uint32_t ga = smem_addr(gs + buf * BW_G), xa = smem_addr(xs + buf * BW_X);
    const uint32_t ka = smem_addr(ks);
    fence_acc(dacc);
    fence_acc(kacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)  // dx: A = G M-major (this warpgroup's 64 positions); D = A B first
      wgmma<128, 1, 1>(dacc, sw128_desc(ga + wg * 16384 + kk * 2048, 16384, 1024),
                       sw128_desc(ka + kk * 2048, 16384, 1024), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)  // dKc: A = G K-major (this warpgroup's 64 taps)
      wgmma<128, 0, 1>(kacc,
                       sw128_desc(ga + (kk >> 2) * 16384 + wg * 8192 + (kk & 3) * 32, 16, 1024),
                       sw128_desc(xa + kk * 2048, 16384, 1024));
    wgmma_commit();
    if (q + 1 < q1) build(q + 1, buf ^ 1, pf);  // G buffer buf ^ 1: tile q - 1's, finished
    wgmma_wait<0>();
    fence_acc(dacc);
    fence_acc(kacc);

    // dx: the tile in bf16 into the staging buffer, in x's swizzled box
    // layout (conflict-free: the 8 rows of a store land in 8 distinct
    // 16-byte chunks), then one TMA store for each of the nbox boxes; the
    // previous tile's store has finished reading the buffer
    if (tid == 0) bulk_wait_read<0>();
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 64; k += 2) {
      const int p = arow + ((k >> 1) & 1) * 8;
      *reinterpret_cast<__nv_bfloat162*>(ds + (k >> 5) * 16384 + sw128(p, (k >> 2) & 7) +
                                         (lane & 3) * 4) =
          __floats2bfloat162_rn(dacc[k], dacc[k + 1]);
    }
    fence_proxy_async();
    __syncthreads();  // G(q + 1) and the staged dx written; tile q's buffers free
    if (tid == 0) {
      // x buffer buf is free: tile q + 2's x goes in before tile q's dx goes out
      if (q + 2 < q1) load_x(q + 2, buf);
      int t, w0, h;
      decode(q, t, w0, h);
      for (int j = 0; j < nbox; ++j)
        tma_store_5d(&dxmap, smem_addr(ds) + j * 16384, c0 + 64 * j, w0, h, t, b);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait<0>();

  float* pb = partial + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * 125 * C;
#pragma unroll
  for (int k = 0; k < 64; k += 2) {
    const int tau = arow + ((k >> 1) & 1) * 8, col = c0 + (k >> 2) * 8 + (lane & 3) * 2;
    if (tau < 125 && col < C)
      *reinterpret_cast<float2*>(pb + static_cast<size_t>(tau) * C + col) =
          make_float2(kacc[k], kacc[k + 1]);
  }
}

int launch_wgmma(const float* g, const void* x, const void* kc, void* dx, float* partial,
                 float* dkc, int B, int T, int H, int W, int C, int splits, int per,
                 cudaStream_t stream) {
  CUtensorMap xmap, kmap, dxmap;
  const long long xd[5] = {C, W, H, T, B};
  const int xb[5] = {64, BW_P, 1, 1, 1};
  if (const int err = tensor_map_bf16(&xmap, x, 5, xd, xb)) return err;
  if (const int err = tensor_map_bf16(&dxmap, dx, 5, xd, xb)) return err;
  const long long kd[3] = {C, NTAPS, B};
  const int kb[3] = {64, 128, 1};
  if (const int err = tensor_map_bf16(&kmap, kc, 3, kd, kb)) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      composite_bwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BW_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int nwt = (W + BW_P - 1) / BW_P;
  const dim3 grid(splits, (C + BW_C - 1) / BW_C, B);
  composite_bwd_wgmma_kernel<<<grid, BW_THREADS, BW_SMEM, stream>>>(
      g, xmap, kmap, dxmap, partial, T, H, W, C, nwt, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int per_b = NTAPS * C;
  reduce_partials<<<dim3((per_b + 255) / 256, B), 256, 0, stream>>>(partial, dkc, splits, per_b);
  return (int)cudaGetLastError();
}

}  // namespace

// f32 (is_bf16 = 0): g (B, 2T, 2H, 2W), x (B, T, H, W, C) and kc (B, 125,
// C), f32 and contiguous, C % 8 == 0, 16-byte aligned x, kc and dx; partial
// (B, ceil(H/16) * ceil(W/16), 125, C) f32 scratch; tile, chunk, splits
// and per are ignored.  bf16 (is_bf16 = 1): g f32 (rounded to bf16 in the
// kernel), x and kc bf16, at the caller's plan (fused_head_kernel.bwd_plan):
// tile = 128 positions, chunk = 128 channels, each sample's T * ceil(W /
// 128) * H tiles in `splits` ranges of `per`, none empty; partial (B,
// splits, 125, C) f32 scratch.  A plan it is not built for is refused with
// cudaErrorInvalidValue.  Both write dx (B, T, H, W, C) in x's type and
// dkc (B, 125, C) f32; launch on `stream`, do not synchronise, and return
// the CUDA error (0 on success).
extern "C" int picad_composite_convt_bwd(const void* g, const void* x, const void* kc,
                                         void* dx, void* partial, void* dkc, int B, int T,
                                         int H, int W, int C, int is_bf16, int tile, int chunk,
                                         int splits, int per, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return launch(g, x, kc, dx, partial, dkc, B, T, H, W, C, s);
  const int ntiles = T * ((W + BW_P - 1) / BW_P) * H;
  if (tile != BW_P || chunk != BW_C || splits < 1 || per < 1 || splits * per < ntiles ||
      (splits - 1) * per >= ntiles)
    return (int)cudaErrorInvalidValue;
  return launch_wgmma(static_cast<const float*>(g), x, kc, dx, static_cast<float*>(partial),
                      static_cast<float*>(dkc), B, T, H, W, C, splits, per, s);
}
