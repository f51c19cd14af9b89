// Composite ConvT forward of the fused decoder head, for Hopper (sm_90a).
//
// Replaces the TPU kernel picad_tpu/ops/pallas_fused_head.py:_fwd_kernel
// (driven by _composite_fwd_impl / composite_convt).  It computes the raw
// composite scatter of fused_head._raw_fused at d = 3:
//
//   out[b, 2i - 2 + tau] += Kc[b, tau, :] . x[b, i, :]      per axis,
//
// i.e. a per-sample ConvT(k5, s2, p2, op1) contracted over channels, with
// x (B, T, H, W, C) channels-last and the output (B, 2T, 2H, 2W) f32
// written interleaved.  Accumulation is f32.  Write each output position
// as o = 2 o' + phi per axis (phi the output phase): input neighbour i =
// o' + s, s in {-1, 0, 1}, reaches phase phi through exactly one tap per
// axis (s = +1: tau = phi; s = 0: tau = 2 + phi; s = -1: tau = 4, phase 0
// only).  What the TPU kernel keeps out of device memory, this one does
// too: the (B, T, H, W, 125) tap tensor of the plain formulation never
// exists.
//
// Bound on an H100 SXM at the train shape, x (16, 4, 112, 112, 128) bf16:
// x 205.5 MB read, out 25.7 MB written (f32), Kc 0.5 MB: 0.069 ms at 3.35
// TB/s, against 25.7 GFLOP of useful work, 0.026 ms on the bf16 tensor
// cores and 0.39 ms on the FP32 cores.  So on the tensor cores it is
// bound by bytes.
//
// bf16: a row-shift decomposition on wgmma (composite_convt_wgmma_kernel).
// The t and h shifts move whole rows of positions, so they become
// accumulating GEMMs over 128-position rows of x, and only the w shift is
// left to fold:
//
//   acc[w, (phi_t, phi_h, tau_w)] = sum_{s_t, s_h} sum_c x[t' + s_t, h' + s_h, w, c]
//                                   * Bop[s_t, s_h, (phi_t, phi_h, tau_w), c]
//   out[2t' + phi_t, 2h' + phi_h, 2w' + phi_w] = sum_{(tau_w, s_w)} acc[w' + s_w, (phi_t, phi_h, tau_w)]
//
// Bop[s_t, s_h, n, c] is Kc at the taps (tau_t(s_t, phi_t), tau_h(s_h,
// phi_h), tau_w), or 0 where the shift feeds no phase, with n = (2 phi_t +
// phi_h) * 5 + tau_w: 20 columns padded to 24 a shift, the shifts in the
// order (s_h, s_t).  The wrapper builds it (fused_head_kernel.fwd_operand:
// (B, 9 * 24, C) bf16, one gather).  A block owns R = 2 output rows h' of
// every frame t' over one w-tile: 128 input positions from w0 - 1, owning
// the outputs w' in [w0, w0 + 126).  It walks the x rows (t, h), h in
// [h0 - 1, h0 + R] inside x, each once, in 64-channel steps: a TMA box of
// 128 positions x 64 channels (x described to TMA as (C, W, H, T, B), so
// w = -1, w >= W and c >= C read as zeros) in a 6-stage ring.  For each
// block row h' = h - s_h, every warpgroup (64 of the 128 positions) issues
// one wgmma m64n72k16 a 16-channel slice: B = Bop's 72 rows at s_h (its 3
// s_t side by side), K-major, resident in shared memory for the block (27
// KB a 64-channel chunk, one TMA box each).  So a product carries the
// three frames t' = t - s_t that x frame t feeds: one m64n24 product per
// (t', h') would issue 3x the wgmma instructions, and at that width their
// issue, not the tensor cores' rate, sets the pace.  After frame t
// each thread adds its accumulator's three 24-column blocks into f32
// partial sums of those frames in shared memory (3 frame slots x R rows x
// 128 x 24; each element one thread's, no barrier); frame t - 1 is then
// complete: the block folds w from its sums and writes each output row
// 2W floats wide, once, with no atomics.  x rows outside x are skipped.
// L2 -> shared traffic is (R + 2) / R = 2x x; the issued work is 1.96x the
// useful work at the train shape (fused_head_kernel.fwd_plan: 72 columns
// for 3 x 20 taps, 128 rows for W's 112, (3H - 2) / H row pairs).  A block
// holds 128 channels of Bop; wider C runs in groups of 128 channels whose
// f32 partial outputs a second kernel sums in a fixed order.
//
// f32: the FP32-core body (composite_convt_kernel), full f32, never TF32.
// Output-stationary gather: one block owns (b, t', a 16 x 16 tile of
// (h', w')).  Per 8-channel step it stages the 3 x 18 x 18 halo of x and
// the 125 x 8 slice of Kc in shared memory, and each thread accumulates
// the 8 phases of 4 vertically adjacent o' in 32 registers.  Lanes run
// along w' so staged-x reads are conflict-free (position stride 12
// floats) and Kc reads are warp-wide broadcasts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

__device__ __forceinline__ void store8(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__global__ void __launch_bounds__(NTHREADS)
composite_convt_kernel(const float* __restrict__ x, const float* __restrict__ kc,
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

  const float* xb = x + (size_t)b * T * H * W * C;
  const float* kb = kc + (size_t)b * NTAPS * C;

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

int launch(const void* x, const void* kc, void* out, int B, int T, int H,
           int W, int C, cudaStream_t stream) {
  // above 48 KB, dynamic shared memory must be opted into; the setting
  // belongs to the current device, so it is made on every launch
  const cudaError_t attr = cudaFuncSetAttribute(
      composite_convt_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * T);
  composite_convt_kernel<<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(kc),
      static_cast<float*>(out), T, H, W, C);
  return (int)cudaGetLastError();
}


// ------------------------------------------------------------- bf16 on wgmma

constexpr int FW_ROWS = 128;              // input positions a w-tile: w0 - 1 .. w0 + 126
constexpr int FW_OWN = FW_ROWS - 2;       // outputs w' a w-tile owns
constexpr int FW_N = 24;                  // Bop's columns a shift: 20 used
constexpr int FW_NT = 3 * FW_N;           // a product's columns: the 3 s_t of one s_h
constexpr int FW_R = 2;                   // output rows h' a block
constexpr int FW_CG = 128;                // channels a block: two 64-channel chunks
constexpr int FW_NS = 6;                  // x ring stages
constexpr int FW_AHEAD = FW_NS - 2;       // steps loaded ahead of the one multiplied
constexpr int FW_THREADS = 256;           // two warpgroups, 64 positions each
constexpr int FW_STAGE = FW_ROWS * 128;   // 16 KB: 128 positions x 64 channels
constexpr int FW_BOP = 9 * FW_N * 128;    // 27 KB: Bop's 9 shifts x 24 columns x 64 channels
constexpr int FW_SLOT = FW_R * FW_ROWS * FW_N;  // one frame t''s partial sums, f32
constexpr int FW_SMEM = 1024 + FW_NS * FW_STAGE + 2 * FW_BOP + 3 * FW_SLOT * 4 + 8 * (FW_NS + 1);
static_assert(FW_BOP % 1024 == 0 && FW_STAGE % 1024 == 0, "the swizzle's 1 KB alignment");
static_assert(FW_SMEM <= 232448, "shared memory");

// One block: frames t' = 0 .. T - 1, rows h' [h0, h0 + FW_R) of sample b
// over the w-tile from w0 - 1, channels [c0, c0 + 128) of group grp =
// blockIdx.z % groups.  xmap: x as (C, W, H, T, B), boxes (64, 128, 1, 1,
// 1); bmap: Bop as (C, 216, B), boxes (64, 216, 1), its shifts in the
// order (s_h, s_t).  Writes out (B, 2T, 2H, 2W) f32, or with groups > 1
// the group's partial ws[grp] of that shape.
__global__ void __launch_bounds__(FW_THREADS, 1)
composite_convt_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                             const __grid_constant__ CUtensorMap bmap, float* __restrict__ out,
                             float* __restrict__ ws, int B, int T, int H, int W, int C,
                             int groups) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* ring = smem;                        // [FW_NS][128 positions][128 B]
  unsigned char* bop = ring + FW_NS * FW_STAGE;      // [chunk][3 s_h][3 s_t][24 columns][128 B]
  float* part = reinterpret_cast<float*>(bop + 2 * FW_BOP);  // [t' % 3][FW_R][128][24]
  const uint32_t bars = smem_addr(part + 3 * FW_SLOT);  // stage i: + 8 i; Bop: + 8 NS
  const uint32_t bop_bar = bars + 8 * FW_NS;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int w0 = blockIdx.x * FW_OWN, h0 = blockIdx.y * FW_R;
  const int b = blockIdx.z / groups, grp = blockIdx.z - b * groups;
  const int c0 = grp * FW_CG;
  const int nkc = min(2, (C - c0 + 63) / 64);        // 64-channel chunks of this group
  const int hlo = max(0, h0 - 1), hhi = min(H, h0 + FW_R + 1);
  const int spf = (hhi - hlo) * nkc;                 // steps a frame: (row, chunk)
  const int nsteps = T * spf;
  float* dst = groups > 1 ? ws + static_cast<size_t>(grp) * B * 8 * T * H * W : out;

  if (tid == 0) {
    for (int i = 0; i <= FW_NS; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = tid; e < 3 * FW_SLOT / 4; e += FW_THREADS)
    reinterpret_cast<float4*>(part)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  auto load = [&](int s) {  // step s = (frame, row, chunk) into stage s % FW_NS
    const int t = s / spf, j = s - t * spf;
    const int h = hlo + j / nkc, kc = j % nkc;
    const uint32_t bar = bars + 8 * (s % FW_NS);
    mbar_expect_tx(bar, FW_STAGE);
    tma_load_5d(smem_addr(ring + (s % FW_NS) * FW_STAGE), &xmap, c0 + 64 * kc, w0 - 1, h, t, b,
                bar);
  };
  if (tid == 0) {
    mbar_expect_tx(bop_bar, nkc * FW_BOP);
    for (int kc = 0; kc < nkc; ++kc)
      tma_load_3d(smem_addr(bop + kc * FW_BOP), &bmap, c0 + 64 * kc, 0, b, bop_bar);
    for (int s = 0; s < FW_AHEAD && s < nsteps; ++s) load(s);
  }

  // acc[r]: frame t's products for row h0 + r, m64n72 layout; columns
  // 24 (s_t + 1) + n feed frame t' = t - s_t
  float acc[FW_R][FW_NT / 2];
#pragma unroll
  for (int r = 0; r < FW_R; ++r)
#pragma unroll
    for (int i = 0; i < FW_NT / 2; ++i) acc[r][i] = 0.f;
  auto fence_all = [&] {
#pragma unroll
    for (int r = 0; r < FW_R; ++r) fence_acc(acc[r]);
  };
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int arow = wg * 64 + warp * 16 + (lane >> 2);  // accumulator row of element 0

  // frame tp is complete: fold w from its partial sums, write its output
  // rows, zero its slot for frame tp + 3
  auto epilogue = [&](int tp) {
    float* z0 = part + (tp % 3) * FW_SLOT;
    __syncthreads();  // every thread's sums are in
    const size_t W2 = 2 * static_cast<size_t>(W);
    for (int e = tid; e < FW_R * 4 * FW_OWN; e += FW_THREADS) {
      const int pp = e & 3, rest = e >> 2;  // pp = 2 phi_t + phi_h (lanes: 4 at a row)
      const int wl = rest % FW_OWN, r = rest / FW_OWN;
      const int hp = h0 + r, wp = w0 + wl;
      if (hp >= H || wp >= W) continue;
      const float* z = z0 + (r * FW_ROWS + wl + 1) * FW_N + pp * 5;  // the row of w'
      // phase 0: taps 0, 2, 4 at w' + 1, w', w' - 1; phase 1: taps 1, 3 at w' + 1, w'
      const float v0 = z[FW_N] + z[2] + z[4 - FW_N];
      const float v1 = z[FW_N + 1] + z[3];
      const size_t orow =
          (static_cast<size_t>(b) * 2 * T + 2 * tp + (pp >> 1)) * (2 * static_cast<size_t>(H)) +
          2 * hp + (pp & 1);
      *reinterpret_cast<float2*>(dst + orow * W2 + 2 * wp) = make_float2(v0, v1);
    }
    __syncthreads();
    for (int e = tid; e < FW_SLOT / 4; e += FW_THREADS)
      reinterpret_cast<float4*>(z0)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  };

  mbar_wait(bop_bar, 0);
  int s = 0;
  for (int t = 0; t < T; ++t) {
    // a row's first product of the frame writes acc[r] (wgmma's scale-d
    // 0) instead of adding to it, so no other instruction defines it
    int fresh[FW_R];
#pragma unroll
    for (int r = 0; r < FW_R; ++r) fresh[r] = 1;
    // row slot j (x row h0 - 1 + j) feeds the block's rows r = j - 2 .. j,
    // so after unrolling every product and its shift s_h = j - 1 - r are
    // known at compile time: no branch inside a step's wgmma sequence
#pragma unroll
    for (int j = 0; j < FW_R + 2; ++j) {
      const int h = h0 - 1 + j;
      if (h < 0 || h >= H) continue;  // rows outside x are not steps
      for (int kc = 0; kc < nkc; ++kc, ++s) {
        // step s has landed, and every warpgroup's wgmma of step s - 2
        // has finished: its stage takes step s + FW_AHEAD
        mbar_wait(bars + 8 * (s % FW_NS), (s / FW_NS) & 1);
        __syncthreads();
        if (tid == 0 && s + FW_AHEAD < nsteps) load(s + FW_AHEAD);
        const uint32_t a = smem_addr(ring + (s % FW_NS) * FW_STAGE) + wg * 8192;
        const uint32_t bk = smem_addr(bop + kc * FW_BOP);
        fence_all();
        wgmma_fence();
#pragma unroll
        for (int r = 0; r < FW_R; ++r) {
          const int sh = j - 1 - r;
          if (sh < -1 || sh > 1) continue;
          const uint32_t bb = bk + (sh + 1) * (FW_NT * 128);  // Bop's 3 s_t at s_h: 72 rows
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma<FW_NT, 0, 0>(acc[r], sw128_desc(a + kk * 32, 16, 1024),
                               sw128_desc(bb + kk * 32, 16, 1024), kk > 0 || !fresh[r]);
          fresh[r] = 0;
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_all();
      }
    }
    wgmma_wait<0>();
    fence_all();
    // the frame's products into the partial sums of t' = t - s_t (each
    // element is one thread's: no barrier; conflict-free, rows 24 floats)
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int tp = t - (u - 1);
      if (tp < 0 || tp >= T) continue;
      float* z = part + (tp % 3) * FW_SLOT;
#pragma unroll
      for (int r = 0; r < FW_R; ++r)
#pragma unroll
        for (int i = 12 * u; i < 12 * u + 12; i += 2) {
          const int row = arow + ((i >> 1) & 1) * 8, col = ((i >> 2) - 3 * u) * 8 + (lane & 3) * 2;
          float2* p = reinterpret_cast<float2*>(z + (r * FW_ROWS + row) * FW_N + col);
          float2 v = *p;
          v.x += acc[r][i];
          v.y += acc[r][i + 1];
          *p = v;
        }
    }
    if (t >= 1) epilogue(t - 1);
    if (t == T - 1) epilogue(t);
  }
}

// out = the sum of the groups' partials ws[0], ..., ws[groups - 1], in that order
__global__ void composite_convt_group_sum(const float4* __restrict__ ws, float4* __restrict__ out,
                                          int groups, size_t n4) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float4 v = ws[i];
    for (int k = 1; k < groups; ++k) {
      const float4 u = ws[k * n4 + i];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    out[i] = v;
  }
}

int launch_wgmma(const void* x, const void* bop, float* out, float* ws, int B, int T, int H,
                 int W, int C, int groups, cudaStream_t stream) {
  CUtensorMap xmap, bmap;
  const long long xd[5] = {C, W, H, T, B};
  const int xb[5] = {64, FW_ROWS, 1, 1, 1};
  if (const int err = tensor_map_bf16(&xmap, x, 5, xd, xb)) return err;
  const long long bd[3] = {C, 9 * FW_N, B};
  const int bb[3] = {64, 9 * FW_N, 1};
  if (const int err = tensor_map_bf16(&bmap, bop, 3, bd, bb)) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      composite_convt_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FW_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((W + FW_OWN - 1) / FW_OWN, (H + FW_R - 1) / FW_R, B * groups);
  composite_convt_wgmma_kernel<<<grid, FW_THREADS, FW_SMEM, stream>>>(xmap, bmap, out, ws, B, T,
                                                                       H, W, C, groups);
  if (groups > 1) {
    const size_t n4 = static_cast<size_t>(B) * 8 * T * H * W / 4;
    const int blocks = static_cast<int>((n4 + 255) / 256 < 4096 ? (n4 + 255) / 256 : 4096);
    composite_convt_group_sum<<<blocks, 256, 0, stream>>>(
        reinterpret_cast<const float4*>(ws), reinterpret_cast<float4*>(out), groups, n4);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// f32 (is_bf16 = 0): x (B, T, H, W, C) and kc (B, 125, C) f32, contiguous,
// C % 8 == 0, 16-byte aligned; rows, w_own, groups and ws are ignored.
// bf16 (is_bf16 = 1): x bf16 as above and kc = Bop (B, 216, C) bf16
// (fused_head_kernel.fwd_operand), at the caller's plan
// (fused_head_kernel.fwd_plan): rows = 2 output rows a block, w_own =
// 126 outputs w' a w-tile, groups = ceil(C / 128) channel groups, and for
// groups > 1 the workspace ws (groups, B, 2T, 2H, 2W) f32; a plan it is
// not built for is refused with cudaErrorInvalidValue.  out (B, 2T, 2H,
// 2W) f32.  Launches on `stream`, does not synchronise, and returns the
// CUDA error (0 on success).
extern "C" int picad_composite_convt(const void* x, const void* kc, void* out, void* ws, int B,
                                     int T, int H, int W, int C, int is_bf16, int rows,
                                     int w_own, int groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return launch(x, kc, out, B, T, H, W, C, s);
  if (rows != FW_R || w_own != FW_OWN || groups != (C + FW_CG - 1) / FW_CG ||
      (groups > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  return launch_wgmma(x, kc, static_cast<float*>(out), static_cast<float*>(ws), B, T, H, W, C,
                      groups, s);
}
