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
// The first maximum is recomputed from x and y (the forward's output): no
// indices are kept from the forward, nothing is scattered, there are no
// atomics, so the result is the same from run to run.  The plain version
// (ops/convops.py: max_pool_bwd_plain) sums in the same order, so the two
// agree bit for bit in f32.  The kernel reads the unpadded x and makes the
// zero pads itself: a pad counts in the windows (the reference zero-pads,
// then pools), can be the first maximum, and its share is dropped, as the
// pad's transpose drops it in JAX.
//
// Bound on an H100 SXM (3.35 TB/s), bf16 at the train step's three strided
// pools: x, y and g read once and dx written once, 256.9 / 96.3 / 72.2 MB
// at MaxPool3d_2a (16, 64, 4, 112, 112) / 3a (16, 192, 2, 56, 56) / 4a
// (16, 480, 2, 28, 28), is 0.0767 / 0.0288 / 0.0216 ms; the compares are a
// few per element.  So it is bound by bytes, but only if the instructions
// per element stay few and enough bytes are in flight: the earlier
// two-pass kernel (a byte of first-max tap per window in device memory,
// then one thread per element with runtime divisions, 64-bit window
// addresses and a runtime-sized, data-dependent scan) ran at 10x this
// bound, set by its instructions, not by its loads.  So here:
//   - one launch, no scratch in device memory; a block of threads owns
//     tiles of dx, 16 bytes along W (8 bf16 or 4 f32) by MH stride-cells
//     along H by one along T each.  It first copies what its windows read
//     (x rows, y and g rows) into shared memory with cp.async, every copy
//     in flight at once, zeros stored for the pads with no load; then it
//     finds each window's first maximum once, as a tap index (a byte) in
//     shared memory; then each thread adds, for each element of its tile,
//     the g of the windows whose first maximum it is;
//   - the window is a template parameter: the two windows of the model's
//     strided pools ((1,3,3)/(1,2,2), (3,3,3)/(2,1,1), models/i3d.py:48-50)
//     unroll every tap loop, and a first maximum is a chain of selects
//     over the unrolled taps, with no data-dependent branch; each
//     element's offset in each window is a constant; any other window
//     runs the same kernel template with its loop bounds read at run time
//     (`Runtime`: a thread owns one stride cell and reads x from the
//     cache);
//   - tiles start on a window start (their origin is shifted by lo % s),
//     so no thread divides at run time; offsets are 32-bit within a plane;
//     blocks map to (plane, H blocks, T tile) by the grid;
//   - x rows and dx rows move as 16-byte vectors where the row allows it
//     (at MaxPool3d_2a and 3a; 8 bytes at 4a's 56-byte rows), y and g rows
//     as 8- or 16-byte vectors.
// PERF.md has the designs tried and their times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int NTHREADS = 256;
constexpr int NO_TAP = -1;   // no tap of the window equals its y (a NaN window)
constexpr int NO_CODE = 255;  // a window code in shared memory: no tap equals y, or no window

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// one 32-bit word of T as floats (element 0 in the low half)
__device__ __forceinline__ void unpack(uint32_t w, float* o, const float*) {
  o[0] = __uint_as_float(w);
}
__device__ __forceinline__ void unpack(uint32_t w, float* o, const __nv_bfloat16*) {
  o[0] = __uint_as_float(w << 16);
  o[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t pack(const float* v, const float*) { return __float_as_uint(v[0]); }
__device__ __forceinline__ uint32_t pack(const float* v, const __nv_bfloat16*) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v[0], v[1]);
  return *reinterpret_cast<const uint32_t*>(&h);
}

struct Geom {
  int T, H, W;          // x and dx, per plane
  int To, Ho, Wo;       // y and g, per plane
  int kt, kh, kw;       // window (read by the run-time instantiation)
  int st, sh, sw;       // stride (idem)
  int lt, lh, lw;       // low pads (idem)
  int at, ah, aw;       // (k - 1) / s: the windows a tile reaches back over (idem)
  int rt, rh, rw;       // lo % s: each tile starts this far before a multiple of its size
  int jt0, jh0, jw0;    // (lo - r) / s: the window that starts at tile 0's origin
  int nT, nH, nW;       // tiles along each axis
  int nWB;              // blocks along W (blockIdx.z = T tile * nWB + W block)
  int sbuf;             // elements a block stages in shared memory
  int wrows, wcols;     // window rows of a block; bytes a row of its window codes takes
  int fs, rs, js, rys;  // a block's staged x frames and rows, window frames and rows
  int srx, sry;         // elements a staged x row, y or g row holds
  int gx, gy;           // bytes a copy into shared memory moves: x rows, y and g rows
  int vx, vy, vd;       // bytes a vector access moves: staged x rows, y and g rows, dx rows
};

// o[0, NB) = p[0, NB) as floats, by vectors of vb bytes (p is aligned to vb)
template <typename T, int NB>
__device__ __forceinline__ void load_body(const T* p, int vb, float* o) {
  constexpr int BYTES = NB * (int)sizeof(T), PW = 4 / (int)sizeof(T);
  const T* tag = nullptr;
  if constexpr (BYTES % 16 == 0) {
    if (vb >= 16) {
#pragma unroll
      for (int i = 0; i < BYTES / 16; ++i) {
        const uint4 u = reinterpret_cast<const uint4*>(p)[i];
        unpack(u.x, o + (4 * i) * PW, tag);
        unpack(u.y, o + (4 * i + 1) * PW, tag);
        unpack(u.z, o + (4 * i + 2) * PW, tag);
        unpack(u.w, o + (4 * i + 3) * PW, tag);
      }
      return;
    }
  }
  if constexpr (BYTES % 8 == 0) {
    if (vb >= 8) {
#pragma unroll
      for (int i = 0; i < BYTES / 8; ++i) {
        const uint2 u = reinterpret_cast<const uint2*>(p)[i];
        unpack(u.x, o + (2 * i) * PW, tag);
        unpack(u.y, o + (2 * i + 1) * PW, tag);
      }
      return;
    }
  }
  if constexpr (BYTES % 4 == 0) {
    if (vb >= 4) {
#pragma unroll
      for (int i = 0; i < BYTES / 4; ++i)
        unpack(reinterpret_cast<const unsigned int*>(p)[i], o + i * PW, tag);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < NB; ++k) o[k] = to_f(p[k]);
}

// p[0, NB) = v[0, NB) in T, by vectors of vb bytes (p is aligned to vb)
template <typename T, int NB>
__device__ __forceinline__ void store_body(T* __restrict__ p, int vb, const float* v) {
  constexpr int BYTES = NB * (int)sizeof(T), PW = 4 / (int)sizeof(T);
  const T* tag = nullptr;
  if constexpr (BYTES % 16 == 0) {
    if (vb >= 16) {
#pragma unroll
      for (int i = 0; i < BYTES / 16; ++i)
        reinterpret_cast<uint4*>(p)[i] =
            make_uint4(pack(v + (4 * i) * PW, tag), pack(v + (4 * i + 1) * PW, tag),
                       pack(v + (4 * i + 2) * PW, tag), pack(v + (4 * i + 3) * PW, tag));
      return;
    }
  }
  if constexpr (BYTES % 8 == 0) {
    if (vb >= 8) {
#pragma unroll
      for (int i = 0; i < BYTES / 8; ++i)
        reinterpret_cast<uint2*>(p)[i] =
            make_uint2(pack(v + (2 * i) * PW, tag), pack(v + (2 * i + 1) * PW, tag));
      return;
    }
  }
  if constexpr (BYTES % 4 == 0) {
    if (vb >= 4) {
#pragma unroll
      for (int i = 0; i < BYTES / 4; ++i)
        reinterpret_cast<unsigned int*>(p)[i] = pack(v + i * PW, tag);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < NB; ++k) store1(p + k, v[k]);
}

// o[0, L) = s[0, L) as floats, s a row in shared memory; [B0, B0 + NB) by
// vectors of vb bytes (s + B0 is aligned to vb), the rest one by one
template <typename T, int L, int B0, int NB>
__device__ __forceinline__ void read_row(const T* s, int vb, float (&o)[L]) {
  load_body<T, NB>(s + B0, vb, o + B0);
#pragma unroll
  for (int k = 0; k < L; ++k)
    if (k < B0 || k >= B0 + NB) o[k] = to_f(s[k]);
}

// 16 bytes (or 8, or 4) from device to shared memory, in flight until cp_async_wait_all
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(BYTES));
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// BYTES of zeros at d
template <int BYTES>
__device__ __forceinline__ void zero_bytes(void* d) {
  if constexpr (BYTES == 16) *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (BYTES == 8) *reinterpret_cast<uint2*>(d) = make_uint2(0u, 0u);
  if constexpr (BYTES == 4) *reinterpret_cast<unsigned int*>(d) = 0u;
  if constexpr (BYTES == 2) *reinterpret_cast<unsigned short*>(d) = 0;
}

// d[0, E) = row[c0, c0 + E), E = BYTES / sizeof(T), 0 outside [0, len): a
// cp.async where the piece lies inside the row (BYTES >= 4), zeros where
// it lies outside, else one by one
template <int BYTES, typename T>
__device__ __forceinline__ void stage_piece(T* d, const T* __restrict__ row, int c0, int len) {
  constexpr int E = BYTES / (int)sizeof(T);
  if (c0 >= len || c0 + E <= 0) {
    zero_bytes<BYTES>(d);
    return;
  }
  if constexpr (BYTES >= 4) {
    if (c0 >= 0 && c0 + E <= len) {
      cp_async<BYTES>(d, row + c0);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e)
    store1(d + e, (unsigned)(c0 + e) < (unsigned)len ? to_f(row[c0 + e]) : 0.f);
}

// s[i] = row[cs + i] for i < srow (cs a multiple of 16 bytes), 0 where cs
// + i falls outside [0, len); 16-byte chunks over the block's x threads,
// each in pieces of vg bytes (row is aligned to vg); row null: all zeros
template <typename T>
__device__ __forceinline__ void stage_row(T* s, const T* __restrict__ row, int cs, int len,
                                          int srow, int vg) {
  constexpr int V = 16 / (int)sizeof(T), ES = (int)sizeof(T);
  for (int k = threadIdx.x; k * V < srow; k += blockDim.x) {
    const int c0 = cs + k * V;
    T* d = s + k * V;
    if (row == nullptr || c0 >= len || c0 + V <= 0) {
      zero_bytes<16>(d);
    } else if (vg >= 16) {
      stage_piece<16>(d, row, c0, len);
    } else if (vg == 8) {
#pragma unroll
      for (int i = 0; i < 2; ++i) stage_piece<8>(d + i * (8 / ES), row, c0 + i * (8 / ES), len);
    } else if (vg == 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) stage_piece<4>(d + i * (4 / ES), row, c0 + i * (4 / ES), len);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) stage_piece<ES>(d + i, row, c0 + i, len);
    }
  }
}

// the windows the model's strided pools use, fixed at compile time, and
// the tile a thread owns: 16 bytes along W by MH stride-cells along H by one along T
template <int KT_, int KH_, int KW_, int ST_, int SH_, int SW_, int MH_>
struct Fixed {
  static constexpr bool fixed = true;
  static constexpr int KT = KT_, KH = KH_, KW = KW_, ST = ST_, SH = SH_, SW = SW_;
  static constexpr int MH = MH_;
};

// any other window, read from Geom at run time; a thread owns one stride cell
struct Runtime {
  static constexpr bool fixed = false;
};

// the shapes of a Fixed window's tile, for the kernel and its launch
template <typename T, class F>
struct Plan {
  static constexpr int KT = F::KT, KH = F::KH, KW = F::KW, ST = F::ST, SH = F::SH, SW = F::SW;
  static constexpr int V = 16 / (int)sizeof(T);  // 16 bytes of dx along W
  static constexpr int NT = ST, NH = F::MH * SH, NW = V, MW = V / SW;
  static constexpr int AT = (KT - 1) / ST, AH = (KH - 1) / SH, AW = (KW - 1) / SW;
  static constexpr int JT = AT + 1, JH = AH + F::MH, JW = AW + MW;  // windows over a tile
  static constexpr int HL = AW * SW;                                    // x columns left of it
  static constexpr int L = HL + NW + (KW > SW ? KW - SW : 0);  // x columns a window row reads
  static constexpr int FR = AT * ST + KT;                      // x frames under a block's windows
  static constexpr int HX = AH * SH;                           // x rows above its first tile row
  static constexpr int RX = HX + (KH > SH ? KH - SH : 0);      // x rows past its tiles' own
  static_assert(V % SW == 0, "a tile holds whole stride cells along W");
  static_assert(HL + SW - 1 <= V && AW <= V, "the left halo fits the staged rows' zero prefix");
  static_assert(KT * KH * KW < NO_CODE, "a tap index fits a byte");
};

// One block: the tiles (blockDim.x along W) x (blockDim.y along H) of
// one T tile of one plane.  It
//   1. stages what its windows read into shared memory: the x rows
//      (frames, rows) under them and the windows' y and g rows, from 16
//      bytes before its first tile's columns on, zeros where that leaves
//      the tensor, all copies in flight at once (cp.async); x frames and
//      rows outside the tensor are pads and read a row of zeros;
//   2. finds the first maximum of every window over its tiles, each once,
//      as a tap index (a byte) in shared memory: a thread the windows that
//      start in its tile's columns, the block's window rows shared out
//      over its rows of threads; the first column of threads also the
//      windows that start left of the block's first tile;
//   3. each thread adds, for each element of its tile, the g of the
//      windows whose first maximum it is, and stores 16 bytes a row.
// Window coordinates in the block: frame bf in [0, JT), row br in [0,
// by * MH + AH), column bc in [0, bx * MW + AW); a tile (tx, ty) is
// covered by rows ty * MH + [0, JH) and columns tx * MW + [0, JW).
template <typename T, class F>
__device__ __forceinline__ void block_fixed(const T* __restrict__ x, const T* __restrict__ y,
                                            const T* __restrict__ g, T* __restrict__ dx,
                                            const Geom& q, int tt, int hb, int wb) {
  using P = Plan<T, F>;
  constexpr int KT = P::KT, KH = P::KH, KW = P::KW, ST = P::ST, SH = P::SH, SW = P::SW;
  constexpr int NT = P::NT, NH = P::NH, NW = P::NW, MW = P::MW, V = P::V;
  constexpr int AT = P::AT, AH = P::AH, AW = P::AW, JT = P::JT, JH = P::JH, JW = P::JW;
  constexpr int HL = P::HL;
  extern __shared__ __align__(16) unsigned char smem[];
  // q.fs frames x q.rs rows x q.srx of x, a row of zeros, q.js frames x
  // q.rys rows x q.sry of y and of g, then the codes, JT x q.wrows x q.wcols
  const int xrows = q.fs * q.rs * q.srx, yrows = q.js * q.rys * q.sry;
  T* const sx = reinterpret_cast<T*>(smem);
  T* const zero = sx + xrows;
  T* const sy = zero + q.srx;
  T* const sg = sy + yrows;
  unsigned char* const codes = smem + (size_t)q.sbuf * sizeof(T);

  const int bx = blockDim.x, by = blockDim.y, tx = threadIdx.x, ty = threadIdx.y;
  const int t0 = tt * NT - q.rt, hb0 = hb * by * NH - q.rh;  // x origin of the block's tiles
  const int cs = wb * bx * NW - V, cys = wb * bx * MW - V;    // x column, window of staged column 0
  // the block's first window frame, row and column
  const int jtb = tt + q.jt0 - AT, jhb0 = hb * by * F::MH + q.jh0 - AH;
  const int jwb0 = wb * bx * MW + q.jw0 - AW;
  // the staged ranges: every x frame and row the windows read that lies in x, and every
  // window frame and row they use (each range clipped into the tensor, fs <= T etc.)
  const int tf = min(max(t0 - AT * ST, 0), q.T - q.fs), hf = min(max(hb0 - P::HX, 0), q.H - q.rs);
  const int jtf = min(max(jtb, 0), q.To - q.js), jhf = min(max(jhb0, 0), q.Ho - q.rys);

  for (int f = 0; f < q.fs; ++f)
    for (int r = ty; r < q.rs; r += by)
      stage_row(sx + (f * q.rs + r) * q.srx, x + ((tf + f) * q.H + hf + r) * q.W, cs, q.W, q.srx,
                q.gx);
  if (ty == 0) stage_row<T>(zero, nullptr, 0, 0, q.srx, 16);
  for (int f = 0; f < q.js; ++f)
    for (int r = ty; r < q.rys; r += by) {
      const int o = ((jtf + f) * q.Ho + jhf + r) * q.Wo, so = (f * q.rys + r) * q.sry;
      stage_row(sy + so, y + o, cys, q.Wo, q.sry, q.gy);
      stage_row(sg + so, g + o, cys, q.Wo, q.sry, q.gy);
    }
  cp_async_wait_all();
  __syncthreads();

  // step 2 for N windows of one row, from column bc: each window's first tap
  // equal to its y, by selects over the taps from last to first
  auto first_max = [&](auto n_windows, int bf, int br, int bc) {
    constexpr int N = decltype(n_windows)::value;
    constexpr int LA = (N - 1) * SW + KW;  // x columns under them
    const int jt = jtb + bf, jh = jhb0 + br, jw = jwb0 + bc;
    int sel[N];
#pragma unroll
    for (int n = 0; n < N; ++n) sel[n] = NO_CODE;
    if (jt >= 0 && jt < q.To && jh >= 0 && jh < q.Ho && jw + N > 0 && jw < q.Wo) {
      float yv[N];
      // own windows (bc = tx * MW + AW) start on 16 bytes of x and MW * 2 or 4 of y
      constexpr bool own = N == MW;
      read_row<T, N, 0, N>(sy + ((jt - jtf) * q.rys + jh - jhf) * q.sry + jwb0 + bc - cys,
                           own ? q.vy : 0, yv);
#pragma unroll
      for (int u = KT - 1; u >= 0; --u) {
        const int t = t0 + (bf - AT) * ST + u;
        float xr[KH][LA];
#pragma unroll
        for (int v = 0; v < KH; ++v) {
          const int h = hb0 - P::HX + br * SH + v;
          const bool in = (unsigned)(t - tf) < (unsigned)q.fs && (unsigned)(h - hf) < (unsigned)q.rs;
          read_row<T, LA, 0, (own ? NW : LA)>(
              (in ? sx + ((t - tf) * q.rs + h - hf) * q.srx : zero) + V - q.rw - HL + bc * SW,
              own ? q.vx : 0, xr[v]);
        }
#pragma unroll
        for (int n = 0; n < N; ++n)
#pragma unroll
          for (int v = KH - 1; v >= 0; --v)
#pragma unroll
            for (int c = KW - 1; c >= 0; --c)
              sel[n] = xr[v][n * SW + c] == yv[n] ? (u * KH + v) * KW + c : sel[n];
      }
    }
    unsigned char* const out = codes + (bf * q.wrows + br) * q.wcols + bc;
#pragma unroll
    for (int n = 0; n < N; ++n)
      out[n] = (unsigned char)(jw + n >= 0 && jw + n < q.Wo ? sel[n] : NO_CODE);
  };

  const int th = hb * by + ty, tw = wb * bx + tx;
  if (tw < q.nW) {
    using Own = std::integral_constant<int, MW>;
    using Left = std::integral_constant<int, AW>;
#pragma unroll
    for (int bf = 0; bf < JT; ++bf)
      for (int br = ty; br < q.wrows; br += by) {
        first_max(Own{}, bf, br, tx * MW + AW);
        if constexpr (AW > 0)
          if (tx == 0) first_max(Left{}, bf, br, 0);
      }
  }
  __syncthreads();
  if (th < q.nH && tw < q.nW) {
    const int h0 = hb0 + ty * NH, w0 = tw * NW - q.rw;  // the tile's origin in x
    float acc[NT][NH][NW];
#pragma unroll
    for (int a = 0; a < NT; ++a)
#pragma unroll
      for (int b = 0; b < NH; ++b)
#pragma unroll
        for (int c = 0; c < NW; ++c) acc[a][b][c] = 0.f;
    // windows in descending order (jt, jh, jw): each element adds its
    // windows' g in order of its offset in them, as the plain version does
#pragma unroll
    for (int it = JT - 1; it >= 0; --it) {
      const int jt = jtb + it;
      if (jt < 0 || jt >= q.To) continue;
#pragma unroll
      for (int ih = JH - 1; ih >= 0; --ih) {
        const int jh = jhb0 + ty * F::MH + ih;
        if (jh < 0 || jh >= q.Ho) continue;
        float gv[JW];
        read_row<T, JW, AW, MW>(sg + ((jt - jtf) * q.rys + jh - jhf) * q.sry + jwb0 + tx * MW - cys,
                                q.vy, gv);
        const unsigned char* const crow = codes + (it * q.wrows + ty * F::MH + ih) * q.wcols + tx * MW;
#pragma unroll
        for (int iw = JW - 1; iw >= 0; --iw) {
          const int code = crow[iw];
#pragma unroll
          for (int u = 0; u < KT; ++u)
#pragma unroll
            for (int v = 0; v < KH; ++v)
#pragma unroll
              for (int c = 0; c < KW; ++c) {
                const int ft = (it - AT) * ST + u, fr = (ih - AH) * SH + v, fc = (iw - AW) * SW + c;
                if (ft >= 0 && ft < NT && fr >= 0 && fr < NH && fc >= 0 && fc < NW &&
                    code == (u * KH + v) * KW + c)
                  acc[ft][fr][fc] += gv[iw];
              }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < NT; ++a)
#pragma unroll
      for (int b = 0; b < NH; ++b) {
        const int t = t0 + a, h = h0 + b;
        if ((unsigned)t >= (unsigned)q.T || (unsigned)h >= (unsigned)q.H) continue;
        T* row = dx + (t * q.H + h) * q.W;
        if (w0 >= 0 && w0 + NW <= q.W) {
          store_body<T, NW>(row + w0, q.vd, acc[a][b]);
        } else {
#pragma unroll
          for (int c = 0; c < NW; ++c)
            if ((unsigned)(w0 + c) < (unsigned)q.W) store1(row + w0 + c, acc[a][b][c]);
        }
      }
  }
}

// x at (t, h, w) of one plane, 0 in the pads
template <typename T>
__device__ __forceinline__ float x_at(const T* __restrict__ x, const Geom& q, int t, int h, int w) {
  return (unsigned)t < (unsigned)q.T && (unsigned)h < (unsigned)q.H && (unsigned)w < (unsigned)q.W
             ? to_f(x[(t * q.H + h) * q.W + w])
             : 0.f;
}

// the run-time window: the same walk with its loop bounds read from Geom;
// a thread owns one stride cell (st, sh, sw) and takes its elements in turn
template <typename T>
__device__ __forceinline__ void cell_runtime(const T* __restrict__ x, const T* __restrict__ y,
                                             const T* __restrict__ g, T* __restrict__ dx,
                                             const Geom& q, int tt, int th, int tw) {
  const int t0 = tt * q.st - q.rt, h0 = th * q.sh - q.rh, w0 = tw * q.sw - q.rw;
  const int jtb = tt + q.jt0, jhb = th + q.jh0, jwb = tw + q.jw0;  // windows starting at the cell
  for (int a = 0; a < q.st; ++a) {
    if ((unsigned)(t0 + a) >= (unsigned)q.T) continue;
    for (int b = 0; b < q.sh; ++b) {
      if ((unsigned)(h0 + b) >= (unsigned)q.H) continue;
      for (int c = 0; c < q.sw; ++c) {
        if ((unsigned)(w0 + c) >= (unsigned)q.W) continue;
        float acc = 0.f;
        for (int it = 0; it <= q.at; ++it) {  // jt descending
          const int jt = jtb - it, u = a + it * q.st;
          if (u >= q.kt || jt < 0 || jt >= q.To) continue;
          for (int ih = 0; ih <= q.ah; ++ih) {
            const int jh = jhb - ih, v = b + ih * q.sh;
            if (v >= q.kh || jh < 0 || jh >= q.Ho) continue;
            for (int iw = 0; iw <= q.aw; ++iw) {
              const int jw = jwb - iw, e = c + iw * q.sw;
              if (e >= q.kw || jw < 0 || jw >= q.Wo) continue;
              const int j = (jt * q.Ho + jh) * q.Wo + jw;
              const float m = to_f(y[j]);
              int sel = NO_TAP, tap = q.kt * q.kh * q.kw;
              for (int uu = q.kt - 1; uu >= 0; --uu)
                for (int vv = q.kh - 1; vv >= 0; --vv)
                  for (int cc = q.kw - 1; cc >= 0; --cc) {
                    --tap;
                    if (x_at(x, q, jt * q.st + uu - q.lt, jh * q.sh + vv - q.lh,
                             jw * q.sw + cc - q.lw) == m)
                      sel = tap;
                  }
              if (sel == (u * q.kh + v) * q.kw + e) acc += to_f(g[j]);
            }
          }
        }
        store1(dx + ((t0 + a) * q.H + h0 + b) * q.W + w0 + c, acc);
      }
    }
  }
}

// grid (planes, H blocks, T tiles x W blocks); block (W tiles, H tiles)
template <typename T, class F>
__global__ void __launch_bounds__(NTHREADS)
picad_pool_bwd(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ g,
               T* __restrict__ dx, Geom q) {
  const long long xo = (long long)blockIdx.x * q.T * q.H * q.W;
  const long long yo = (long long)blockIdx.x * q.To * q.Ho * q.Wo;
  if constexpr (F::fixed) {
    // one division a block, where the W blocks share grid.z with the T tiles
    const int tt = q.nWB == 1 ? (int)blockIdx.z : (int)blockIdx.z / q.nWB;
    block_fixed<T, F>(x + xo, y + yo, g + yo, dx + xo, q, tt, blockIdx.y, blockIdx.z - tt * q.nWB);
  } else {
    const int th = blockIdx.y * blockDim.y + threadIdx.y;
    if (th >= q.nH) return;
    for (int tw = threadIdx.x; tw < q.nW; tw += blockDim.x)
      cell_runtime<T>(x + xo, y + yo, g + yo, dx + xo, q, blockIdx.z, th, tw);
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// the largest of 16, 8, 4, 2, 1 bytes that divides every value
int vec_bytes(std::initializer_list<long long> vals) {
  int vb = 16;
  for (long long v : vals)
    while (v % vb != 0) vb >>= 1;
  return vb;
}

template <typename T, class F>
int run(const void* x, const void* y, const void* g, void* dx, int planes, Geom q,
        cudaStream_t stream) {
  constexpr long long es = sizeof(T);
  int MH = 1, NW = q.sw;
  if constexpr (F::fixed) {
    MH = F::MH;
    NW = 16 / (int)sizeof(T);
  }
  const int NT = q.st, NH = MH * q.sh, MW = NW / q.sw;
  q.at = (q.kt - 1) / q.st, q.ah = (q.kh - 1) / q.sh, q.aw = (q.kw - 1) / q.sw;
  q.rt = q.lt % q.st, q.rh = q.lh % q.sh, q.rw = q.lw % q.sw;
  q.jt0 = (q.lt - q.rt) / q.st, q.jh0 = (q.lh - q.rh) / q.sh, q.jw0 = (q.lw - q.rw) / q.sw;
  q.nT = cdiv(q.T + q.rt, NT), q.nH = cdiv(q.H + q.rh, NH), q.nW = cdiv(q.W + q.rw, NW);
  q.vd = vec_bytes({(long long)(uintptr_t)dx, q.W * es, NW * es, q.rw * es});
  int bx = q.nW < NTHREADS ? q.nW : NTHREADS;
  int hblocks = cdiv(q.nH, NTHREADS / bx);  // blocks along H, rows shared out evenly
  int by = cdiv(q.nH, hblocks);
  q.nWB = 1;
  size_t smem = 0;
  if constexpr (F::fixed) {
    using P = Plan<T, F>;
    const int V = P::V;
    q.gx = vec_bytes({(long long)(uintptr_t)x, q.W * es});
    q.vx = vec_bytes({16, q.rw * es});
    q.vy = vec_bytes({16, MW * es, q.jw0 * es});
    auto stage = [&]() {  // bytes of shared memory a block of (bx, by) tiles stages
      q.srx = cdiv(V + (bx - 1) * NW - q.rw - P::HL + P::L, V) * V;
      q.sry = cdiv(V + (bx - 1) * MW + q.jw0 - P::AW + P::JW, V) * V;
      q.fs = P::FR < q.T ? P::FR : q.T;
      q.rs = by * NH + P::RX < q.H ? by * NH + P::RX : q.H;
      q.js = P::JT < q.To ? P::JT : q.To;
      q.rys = by * MH + P::AH < q.Ho ? by * MH + P::AH : q.Ho;
      q.sbuf = q.fs * q.rs * q.srx + q.srx + 2 * q.js * q.rys * q.sry;
      q.wrows = by * MH + P::AH;
      q.wcols = cdiv(bx * MW + P::AW, 16) * 16;
      return (size_t)q.sbuf * es + (size_t)P::JT * q.wrows * q.wcols;
    };
    for (smem = stage(); smem > 48 * 1024 && (by > 1 || bx > 1); smem = stage()) {
      if (by > 1) {  // fewer H tiles a block, then fewer W tiles
        hblocks = cdiv(q.nH, by / 2);
        by = cdiv(q.nH, hblocks);
      } else {
        bx = cdiv(bx, 2);
      }
    }
    q.nWB = cdiv(q.nW, bx);
    q.gy = vec_bytes({(long long)(uintptr_t)y, (long long)(uintptr_t)g, q.Wo * es, bx * MW * es});
  }
  if ((long long)q.nT * q.nWB > 65535 || hblocks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(planes, hblocks, q.nT * q.nWB), block(bx, by);
  picad_pool_bwd<T, F><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(g),
      static_cast<T*>(dx), q);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* y, const void* g, void* dx, int planes, const Geom& q,
             cudaStream_t s) {
  const int w[6] = {q.kt, q.kh, q.kw, q.st, q.sh, q.sw};
  auto is = [&](int a, int b, int c, int d, int e, int f) {
    return w[0] == a && w[1] == b && w[2] == c && w[3] == d && w[4] == e && w[5] == f;
  };
  if (is(1, 3, 3, 1, 2, 2))  // MaxPool3d_2a and 3a
    return run<T, Fixed<1, 3, 3, 1, 2, 2, 2>>(x, y, g, dx, planes, q, s);
  if (is(3, 3, 3, 2, 1, 1))  // MaxPool3d_4a
    return run<T, Fixed<3, 3, 3, 2, 1, 1, 1>>(x, y, g, dx, planes, q, s);
  return run<T, Runtime>(x, y, g, dx, planes, q, s);
}

}  // namespace

// x and dx (planes, T, H, W), y and g (planes, To, Ho, Wo), all contiguous,
// of one type: f32 (bf16 = 0) or bf16 (bf16 = 1); y = the max pool of x
// zero-padded by (lt, lh, lw) below, window (kt, kh, kw), stride (st, sh,
// sw).  A pool of lower rank passes leading dims of size 1 (window 1,
// stride 1, pad 0).  One launch; returns its CUDA error (0 on success).
extern "C" int picad_max_pool_bwd(const void* x, const void* y, const void* g, void* dx,
                                  int planes, int T, int H, int W, int To, int Ho, int Wo,
                                  int kt, int kh, int kw, int st, int sh, int sw, int lt,
                                  int lh, int lw, int bf16, void* stream) {
  if (planes < 0 || T < 0 || H < 0 || W < 0 || To < 0 || Ho < 0 || Wo < 0 || kt < 1 ||
      kh < 1 || kw < 1 || st < 1 || sh < 1 || sw < 1 || lt < 0 || lh < 0 || lw < 0 ||
      (long long)T * H * W > 0x7fffffffLL || (long long)To * Ho * Wo > 0x7fffffffLL ||
      (long long)kt * kh * kw > 0x7fffffffLL || planes > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (planes == 0 || (long long)T * H * W == 0) return 0;
  Geom q{};
  q.T = T, q.H = H, q.W = W, q.To = To, q.Ho = Ho, q.Wo = Wo;
  q.kt = kt, q.kh = kh, q.kw = kw, q.st = st, q.sh = sh, q.sw = sw;
  q.lt = lt, q.lh = lh, q.lw = lw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(x, y, g, dx, planes, q, s)
              : dispatch<float>(x, y, g, dx, planes, q, s);
}
