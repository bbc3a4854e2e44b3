// The int8 conv's paths for what the "tma" path (conv_int8.cu) does not
// take, redesigned for Hopper: "stem", dense convs with a small Cin, and
// "grouped", every conv with groups > 1 at stride 1 or 2. Both compute what
// conv_int8.cu's note states (the same quantization, bit for bit the JAX
// package's, exact int32 sums, the same fp32 epilogue; conv_int8.cuh) and
// both replace the first design's direct path (conv_int8_kernel) on that
// work. kernels/conv_int8.py: plan() picks the path, the tile and the
// shared memory; the entries below compute the layout and check it fits.
//
// Replaces no Pallas kernel: the JAX package's int8 conv is XLA's
// (icafusion_tpu/nn/layers.py:154-176, Conv._int8_conv; groups through
// feature_group_count, :175).
//
// "stem" (conv_int8_stem_kernel): groups 1, Cin % 16 != 0 (the 3-channel
// stem k6 s2 p2, K = 108; the merged stem's Cin 6, K = 216; Focus's Cin 12),
// x fp32 or bf16 in any strides (the engine's stem input is a channels_last
// view with 6-byte pixels), stride 1 or 2, Cout % 8 == 0. What bounds it on
// the H100 is bytes: at 640 px, B = 4, bf16, 9.8 MB in and 52.4 MB out
// (18.6 us at 3.35 TB/s) against 5.66 G int8 operations (2.9 us). The
// first design re-read and re-quantized each input element at every tap,
// loaded one K column of 6-byte pixels a thread and stored 2-byte
// elements. Here:
//   - persistent blocks walk output tiles of th x tw <= 128 pixels;
//   - a tile's input window with its halo, ((th-1)*s + kh) x ((tw-1)*s +
//     kw) pixels of Cin channels, is loaded by threads that each own one
//     channel ci of a run of pixels (consecutive threads read consecutive
//     elements of a channels_last row), into registers while the previous
//     tile's products, epilogue and stores run; then quantized once into
//     shared memory as int8 rows of (pixel, channel), L = hw * Cin bytes a
//     window row, in x's own channels_last order, zeros outside x (the
//     conv's padding: rn(0 / s) = 0);
//   - no im2col: the K order (ky, kx, ci) makes a tap row's kw * Cin
//     operand bytes of output pixel (r, c) one contiguous run of window row
//     r*s + ky from byte c*s*Cin on. Each tap row is cut into groups of 4
//     bytes, the weights zero past kw * Cin, and the kh rows' groups are
//     packed 8 to a k32 step of mma.sync m16n8k32 (s8, exact int32): 4
//     steps for the stem's K = 108 and 7 for the merged stem's 216. An A
//     register is one group, a 4-byte read at any byte offset of the
//     window (two aligned words and a funnel shift; a table gives each
//     group's offset); what it reads past the run meets zero weights;
//   - the weights, (Cout, steps * 32) bytes, stay in shared memory for
//     the whole kernel, rows 16 bytes off a multiple of 128 (no bank
//     conflicts), two n-tiles' fragments an ldmatrix;
//   - 8 warps x 16 pixels, 64 output channels a pass: the fp32 epilogue
//     goes to a staged tile, written out with 16-byte streaming stores of
//     whole pixel runs.
//
// "grouped" (conv_int8_grouped_kernel): every conv with groups > 1 (the
// legacy modules' DWConv, GhostConv and GhostBottleneck depthwise convs),
// stride 1 or 2, kw in {1, 3, 5, 7}. A depthwise 3x3 does 9 multiply-adds
// an output against 4 bytes in and out (bf16): bytes bound it and tensor
// cores buy nothing. The first design gave each group its own 128-column
// mma tile, one column used. Here a block owns th x tw output pixels and a
// chunk of whole groups (at most 64 output channels unless one group has
// more), quantizes the window of the chunk's input channels once into
// shared memory with JAX's per-tensor s_in (the wrapper's (Cin,) copy of
// it; 8 channels a 16-byte load where they lie innermost), and each
// thread keeps one output channel and accumulates 4 neighbouring pixels of
// a row in int32 on the CUDA cores (the inputs of a tap row in registers,
// shared by the 4); the same staged epilogue and 16-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "conv_int8.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using namespace icaf_int8;

constexpr int kStemThreads = 256;
constexpr int kStemBlocks = 2;  // stem: blocks an SM (plan(): its grid)
constexpr int kSlots = 128;     // stem: output pixels a tile (8 warps x 16)
constexpr int kNC = 64;         // stem: output channels a pass and a stage
constexpr int kItemsMax = 24;   // stem: window values a thread holds
constexpr int kThreads = 256;   // grouped
constexpr int kR = 4;           // grouped: pixels a thread accumulates
constexpr int kSmemMax = 232448;

struct Params {
  const void* x;
  long long sb, sc, sh, sw;    // x's element strides (b, c, h, w)
  const int8_t* w8;            // (Cout, kh, kw, Cin / groups)
  const float* s_in;           // (Cin,)
  const float* s_w;            // (Cout,)
  const float* gamma;
  const float* beta;
  const float* mean;
  const float* var;
  float eps;
  void* out;                   // (B, Ho, Wo, Cout): channels_last
  int Cin, H, W, Cout, kh, kw, s, ph, pw, Ho, Wo;
  int th, tw, hh, hw, tiles_w, tiles_h, tiles;
  int act, epi;
  int Lp, Gr, steps, KP;       // stem: window row pitch, 4-byte groups a
                               // tap row, k32 steps, weight row pitch
                               // (bytes)
  int Cin_g, Cout_g, groups, gpc, chunks;   // grouped: gpc groups a block
  int vec;                     // grouped: channels innermost, 16-byte runs
  int pitch;                   // bytes a staged pixel
  uint32_t off_w, off_tab, off_win, off_stage;   // shared memory; mult/add
                                                 // at 0
};

struct Tile {
  int b, h0, w0;
};

__device__ __forceinline__ Tile tile_at(const Params& p, int t) {
  Tile r;
  r.w0 = (t % p.tiles_w) * p.tw;
  r.h0 = (t / p.tiles_w % p.tiles_h) * p.th;
  r.b = t / (p.tiles_w * p.tiles_h);
  return r;
}

// 4 bytes of shared memory from any byte offset (little-endian).
__device__ __forceinline__ uint32_t lds_u32(const int8_t* base, int off) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(base + (off & ~3));
  return __funnelshift_r(w[0], w[1], (off & 3) * 8);
}

// The staged tile -> out: stage pixel r * tw + c (p.pitch bytes apart)
// holds channels c0 .. c0 + nch - 1 of output pixel (h0 + r, w0 + c), esz
// bytes each; pixels past the map are dropped. 16-byte streaming stores
// where the run, its offset and the pixel stride allow, else element ones.
template <int kBlock>
__device__ __forceinline__ void copy_out(const Params& p, const Tile& t,
                                         const unsigned char* stage, int c0,
                                         int nch, int esz) {
  unsigned char* out = static_cast<unsigned char*>(p.out);
  const int rows = min(p.th, p.Ho - t.h0), cols = min(p.tw, p.Wo - t.w0);
  const int seg = nch * esz;
  const bool vec = seg % 16 == 0 && (c0 * esz) % 16 == 0 &&
                   (p.Cout * esz) % 16 == 0;
  const int unit = vec ? 16 : esz, per = seg / unit;
  // thread: unit `part` of its pixels, `step` pixels apart
  const int step = kBlock / per, part = threadIdx.x % per;
  if (static_cast<int>(threadIdx.x) >= step * per) return;
  const long long row_bytes = static_cast<long long>(p.Wo) * p.Cout * esz;
  unsigned char* base =
      out + ((static_cast<long long>(t.b) * p.Ho + t.h0) * p.Wo + t.w0) *
                p.Cout * esz + c0 * esz + part * unit;
  int r = 0, c = threadIdx.x / per;
  while (c >= cols) {
    c -= cols;
    ++r;
  }
  for (; r < rows;) {
    const unsigned char* src = stage + (r * p.tw + c) * p.pitch + part * unit;
    unsigned char* dst = base + r * row_bytes +
                         static_cast<long long>(c) * p.Cout * esz;
    if (vec)
      __stcs(reinterpret_cast<int4*>(dst), *reinterpret_cast<const int4*>(src));
    else if (unit == 4)
      *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
    else
      *reinterpret_cast<unsigned short*>(dst) =
          *reinterpret_cast<const unsigned short*>(src);
    c += step;
    while (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// ===========================================================================
// "stem"
// ===========================================================================

// kN: window values a thread loads a tile (12 or 24; plan() bounds them).
template <typename T, int kN>
__global__ void __launch_bounds__(kStemThreads, kStemBlocks)
    conv_int8_stem_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char sm[];
  float* mult = reinterpret_cast<float*>(sm);
  float* add = mult + p.Cout;
  int8_t* wsm = reinterpret_cast<int8_t*>(sm + p.off_w);
  int* tab = reinterpret_cast<int*>(sm + p.off_tab);
  int8_t* win = reinterpret_cast<int8_t*>(sm + p.off_win);
  unsigned char* stage = sm + p.off_stage;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // K: tap row ky's kw * Cin bytes of w8[co, ky] ((kx, ci) order) in
  // Gr = ceil(kw * Cin / 4) groups of 4 (zeros past the row), the kh * Gr
  // groups packed 8 to a k32 step. tab[G]: where group G's 4 A bytes of
  // output pixel (0, 0) lie in the window (row ky, byte 4 * (G % Gr)).
  const int kwc = p.kw * p.Cin, groups = p.kh * p.Gr;
  for (int i = tid; i < p.Cout * p.steps * 32; i += kStemThreads) {
    const int co = i / (p.steps * 32), k = i - co * p.steps * 32;
    const int G = k / 4, ky = G / p.Gr, b = (G - ky * p.Gr) * 4 + k % 4;
    wsm[co * p.KP + k] =
        G < groups && b < kwc
            ? p.w8[(static_cast<long long>(co) * p.kh + ky) * kwc + b]
            : int8_t(0);
  }
  for (int G = tid; G < p.steps * 8; G += kStemThreads)
    tab[G] = G < groups ? G / p.Gr * p.Lp + G % p.Gr * 4 : 0;
  if (p.epi)
    for (int c = tid; c < p.Cout; c += kStemThreads)
      fold(c, p.s_w, p.gamma, p.beta, p.mean, p.var, p.eps, mult[c], add[c]);

  // The window loader: thread (pixel slot, channel ci); `per` pixels a
  // pass, the k-th pass at window pixel (wr, wc), stepped without a
  // division.
  const int per = kStemThreads / p.Cin;
  const bool loader = tid < per * p.Cin;
  const int ci = tid % p.Cin;
  const float sc = __ldg(p.s_in + ci), rc = __frcp_rn(sc);
  const int wr0 = tid / p.Cin / p.hw, wc0 = tid / p.Cin % p.hw;
  const int dr = per / p.hw, dc = per % p.hw;
  const T* __restrict__ xc = static_cast<const T*>(p.x) + ci * p.sc;
  uint32_t raw[kN];

  auto fetch = [&](int t) {
    const Tile tl = tile_at(p, t);
    const int hi0 = tl.h0 * p.s - p.ph, wi0 = tl.w0 * p.s - p.pw;
    const T* xb = xc + tl.b * p.sb;
    int wr = wr0, wc = wc0;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int h = hi0 + wr, w = wi0 + wc;
      const bool ok = loader && wr < p.hh && h >= 0 && h < p.H && w >= 0 &&
                      w < p.W;
      raw[k] = ok ? load_bits(xb + h * p.sh + w * p.sw) : 0u;
      wc += dc;
      wr += dr;
      if (wc >= p.hw) {
        wc -= p.hw;
        ++wr;
      }
    }
  };
  auto stash = [&]() {
    float v[kN];
    int q[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) v[k] = bits_to_float<T>(raw[k]);
    quantize_n(v, [&](int) { return sc; }, [&](int) { return rc; }, q);
    int wr = wr0, wc = wc0;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      if (loader && wr < p.hh)
        win[wr * p.Lp + wc * p.Cin + ci] = static_cast<int8_t>(q[k]);
      wc += dc;
      wr += dr;
      if (wc >= p.hw) {
        wc -= p.hw;
        ++wr;
      }
    }
  };

  // The warp's 16 A rows are tile slots warp * 16 + g and + 8: output
  // pixel (r, c) = (i / tw, i % tw) reads window row r * s + ky from byte
  // c * s * Cin on (slots past th * tw read slot 0 and are dropped). Lane
  // (g, t) holds groups t and 4 + t of each k32 step.
  const int g = lane >> 2, t = lane & 3;
  const int slots = p.th * p.tw;
  auto row_off = [&](int i) {
    if (i >= slots) i = 0;
    const int r = i / p.tw, c = i - r * p.tw;
    return r * p.s * p.Lp + c * p.s * p.Cin;
  };
  const int i0 = warp * 16 + g;
  const int r0 = row_off(i0), r1 = row_off(i0 + 8);
  // ldmatrix: lane l gives row l % 8 of matrix l / 8, (n-tile, k half) =
  // (l / 16, (l / 8) % 2) of a pair of n-tiles; the k-step adds 32 bytes
  const uint32_t w_lane = smem_u32(wsm) +
                          ((lane >> 4) * 8 + (lane & 7)) * p.KP +
                          ((lane >> 3) & 1) * 16;
  const int esz = p.epi ? static_cast<int>(sizeof(T)) : 4;

  fetch(blockIdx.x);
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const Tile tl = tile_at(p, tile);
    stash();
    __syncthreads();   // the window is in; the stage is free
    if (tile + static_cast<int>(gridDim.x) < p.tiles)
      fetch(tile + gridDim.x);
    for (int n0 = 0; n0 < p.Cout; n0 += kNC) {
      int acc[8][4] = {};
      const uint32_t wl = w_lane + n0 * p.KP;
#pragma unroll 2
      for (int ks = 0; ks < p.steps; ++ks) {
        const int o0 = tab[8 * ks + t], o1 = tab[8 * ks + 4 + t];
        const uint32_t a[4] = {lds_u32(win, r0 + o0), lds_u32(win, r1 + o0),
                               lds_u32(win, r0 + o1), lds_u32(win, r1 + o1)};
#pragma unroll
        for (int jn = 0; jn < 8; jn += 2)
          if (n0 + 8 * jn < p.Cout) {
            uint32_t b[4];   // n-tiles jn and jn + 1 (past Cout: unused)
            ldmatrix_x4(b, wl + 8 * jn * p.KP + 32 * ks);
            mma_s8_16832(acc[jn], a, b[0], b[1]);
            if (n0 + 8 * jn + 8 < p.Cout)
              mma_s8_16832(acc[jn + 1], a, b[2], b[3]);
          }
      }
      // rows i0 (acc[jn][0, 1]) and i0 + 8 ([2, 3]); channels n0 + 8 jn +
      // 2 t and + 1; two n-tiles' 8 values computed before they are stored
#pragma unroll
      for (int jn = 0; jn < 8; jn += 2) {
        if (n0 + 8 * jn >= p.Cout) break;
        const int nt = n0 + 8 * jn + 8 < p.Cout ? 2 : 1;   // n-tiles here
        float y[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int n = n0 + 8 * (jn + e / 4) + 2 * t + (e & 1);
          y[e] = p.epi && e / 4 < nt
                     ? epilogue(acc[jn + e / 4][e & 3], mult[n], add[n], p.act)
                     : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (u >= nt) continue;
            unsigned char* dst = stage + (i0 + 8 * h) * p.pitch +
                                 (8 * (jn + u) + 2 * t) * esz;
            const int e = 4 * u + 2 * h;
            if (!p.epi)
              *reinterpret_cast<int2*>(dst) =
                  make_int2(acc[jn + u][2 * h], acc[jn + u][2 * h + 1]);
            else if constexpr (sizeof(T) == 2)
              *reinterpret_cast<uint32_t*>(dst) = pack_bf16(y[e], y[e + 1]);
            else
              *reinterpret_cast<float2*>(dst) = make_float2(y[e], y[e + 1]);
          }
      }
      __syncthreads();   // the stage is full; the window is free
      copy_out<kStemThreads>(p, tl, stage, n0, min(kNC, p.Cout - n0), esz);
      if (n0 + kNC < p.Cout) __syncthreads();
    }
  }
}

// ===========================================================================
// "grouped"
// ===========================================================================

// Four blocks an SM up to kw 3 (64 registers a thread), two above.
template <typename T, int kS, int kKW>
__global__ void __launch_bounds__(kThreads, kKW <= 3 ? 4 : 2)
    conv_int8_grouped_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int chunk = blockIdx.x % p.chunks;
  const Tile tl = tile_at(p, blockIdx.x / p.chunks);
  const int g0 = chunk * p.gpc, ng = min(p.gpc, p.groups - g0);
  const int cin = ng * p.Cin_g, cout = ng * p.Cout_g;   // this chunk's
  const int ci_lo = g0 * p.Cin_g, co_lo = g0 * p.Cout_g;
  float* mult = reinterpret_cast<float*>(sm);
  float* add = mult + p.gpc * p.Cout_g;
  int8_t* wsm = reinterpret_cast<int8_t*>(sm + p.off_w);    // [tap][j][co]
  int8_t* win = reinterpret_cast<int8_t*>(sm + p.off_win);  // [wr][wc][ci]
  unsigned char* stage = sm + p.off_stage;
  const int tid = threadIdx.x;
  const int kg = p.kh * kKW * p.Cin_g;   // w8's row: (ky, kx, j)

  for (int i = tid; i < cout * kg; i += kThreads) {
    const int co = i / kg, k = i - co * kg;
    wsm[k * cout + co] = p.w8[static_cast<long long>(co_lo + co) * kg + k];
  }
  if (p.epi)
    for (int c = tid; c < cout; c += kThreads)
      fold(co_lo + c, p.s_w, p.gamma, p.beta, p.mean, p.var, p.eps, mult[c],
           add[c]);

  // The window, quantized once. Where the chunk's channels lie innermost
  // in 16-byte runs (p.vec and cin % 8 == 0): thread (pixel slot, 8
  // channels), one 16-byte load (32 for fp32) an item, 4 items in flight;
  // else thread (pixel slot, channel ci), 8 pixels in flight.
  {
    const int hi0 = tl.h0 * kS - p.ph, wi0 = tl.w0 * kS - p.pw;
    const T* __restrict__ xb =
        static_cast<const T*>(p.x) + tl.b * p.sb + ci_lo * p.sc;
    if (p.vec && cin % 8 == 0) {
      const int g8 = cin / 8, per = kThreads / g8;
      if (tid < per * g8) {
        const int c8 = (tid % g8) * 8;
        float sc[8], rc[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          sc[e] = __ldg(p.s_in + ci_lo + c8 + e);
          rc[e] = __frcp_rn(sc[e]);
        }
        const int dr = per / p.hw, dc = per % p.hw;
        int wr = tid / g8 / p.hw, wc = tid / g8 % p.hw;
        constexpr int kU = 4;
        while (wr < p.hh) {
          Raw8<T> raw[kU];
          int rr[kU], cc[kU];
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            rr[u] = wr;
            cc[u] = wc;
            const int h = hi0 + wr, w = wi0 + wc;
            const bool ok =
                wr < p.hh && h >= 0 && h < p.H && w >= 0 && w < p.W;
            load8(xb + h * p.sh + w * p.sw + c8, ok, raw[u]);
            wc += dc;
            wr += dr;
            if (wc >= p.hw) {
              wc -= p.hw;
              ++wr;
            }
          }
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            if (rr[u] >= p.hh) break;
            float v[8];
            unpack8(raw[u], v);
            uint32_t q8[2];
            quantize8(v, sc, rc, q8);
            *reinterpret_cast<uint2*>(win + (rr[u] * p.hw + cc[u]) * cin +
                                      c8) = make_uint2(q8[0], q8[1]);
          }
        }
      }
    } else {
      const int per = kThreads / cin;
      if (tid < per * cin) {
        const int ci = tid % cin;
        const float sc = __ldg(p.s_in + ci_lo + ci), rc = __frcp_rn(sc);
        const T* __restrict__ x = xb + ci * p.sc;
        const int dr = per / p.hw, dc = per % p.hw;
        int wr = tid / cin / p.hw, wc = tid / cin % p.hw;
        constexpr int kU = 8;
        while (wr < p.hh) {
          float v[kU];
          int rr[kU], cc[kU], q[kU];
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            rr[u] = wr;
            cc[u] = wc;
            const int h = hi0 + wr, w = wi0 + wc;
            const bool ok =
                wr < p.hh && h >= 0 && h < p.H && w >= 0 && w < p.W;
            v[u] = ok ? bits_to_float<T>(load_bits(x + h * p.sh + w * p.sw))
                      : 0.f;
            wc += dc;
            wr += dr;
            if (wc >= p.hw) {
              wc -= p.hw;
              ++wr;
            }
          }
          quantize_n(v, [&](int) { return sc; }, [&](int) { return rc; }, q);
#pragma unroll
          for (int u = 0; u < kU; ++u)
            if (rr[u] < p.hh)
              win[(rr[u] * p.hw + cc[u]) * cin + ci] =
                  static_cast<int8_t>(q[u]);
        }
      }
    }
  }
  __syncthreads();

  // Thread (output channel co, strips of kR pixels along a tile row).
  const int per = kThreads / cout;
  const int esz = p.epi ? static_cast<int>(sizeof(T)) : 4;
  if (tid < per * cout) {
    const int co = tid % cout;
    const int ci0 = (co / p.Cout_g) * p.Cin_g;
    const int strips = p.tw / kR;
    constexpr int kX = (kR - 1) * kS + kKW;   // a tap row's inputs
    for (int si = tid / cout; si < p.th * strips; si += per) {
      const int r = si / strips, q = si - r * strips;
      int acc[kR] = {};
      for (int ky = 0; ky < p.kh; ++ky) {
        const int8_t* xr =
            win + ((r * kS + ky) * p.hw + q * kR * kS) * cin + ci0;
        const int8_t* wr = wsm + ky * kKW * p.Cin_g * cout + co;
        for (int j = 0; j < p.Cin_g; ++j) {
          int xv[kX];
#pragma unroll
          for (int u = 0; u < kX; ++u) xv[u] = xr[u * cin + j];
#pragma unroll
          for (int kx = 0; kx < kKW; ++kx) {
            const int w = wr[(kx * p.Cin_g + j) * cout];
#pragma unroll
            for (int e = 0; e < kR; ++e) acc[e] += xv[e * kS + kx] * w;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < kR; ++e) {
        unsigned char* dst =
            stage + (r * p.tw + q * kR + e) * p.pitch + co * esz;
        if (!p.epi) {
          *reinterpret_cast<int*>(dst) = acc[e];
          continue;
        }
        const float y = epilogue(acc[e], mult[co], add[co], p.act);
        if constexpr (sizeof(T) == 2)
          *reinterpret_cast<__nv_bfloat16*>(dst) = __float2bfloat16_rn(y);
        else
          *reinterpret_cast<float*>(dst) = y;
      }
    }
  }
  __syncthreads();
  copy_out<kThreads>(p, tl, stage, co_lo, cout, esz);
}

// ---- host ------------------------------------------------------------------

int round16(long long v) { return static_cast<int>((v + 15) / 16 * 16); }

template <int kBlock, typename Kernel>
cudaError_t run(Kernel kernel, bool* opted, int grid, int smem,
                cudaStream_t st, const Params& p) {
  cudaError_t err = opt_in_smem(kernel, kSmemMax, opted);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kBlock, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_stem(const Params& p, int items, int grid, int smem,
                        cudaStream_t st) {
  static bool opted[2][kMaxDevices];
  if (items <= 12)
    return run<kStemThreads>(conv_int8_stem_kernel<T, 12>, opted[0], grid, smem, st, p);
  return run<kStemThreads>(conv_int8_stem_kernel<T, kItemsMax>, opted[1], grid, smem, st,
             p);
}

template <typename T, int kS>
cudaError_t launch_grouped_s(const Params& p, int grid, int smem,
                             cudaStream_t st) {
  static bool opted[4][kMaxDevices];
  switch (p.kw) {
    case 1:
      return run<kThreads>(conv_int8_grouped_kernel<T, kS, 1>, opted[0], grid, smem, st,
                 p);
    case 3:
      return run<kThreads>(conv_int8_grouped_kernel<T, kS, 3>, opted[1], grid, smem, st,
                 p);
    case 5:
      return run<kThreads>(conv_int8_grouped_kernel<T, kS, 5>, opted[2], grid, smem, st,
                 p);
    default:
      return run<kThreads>(conv_int8_grouped_kernel<T, kS, 7>, opted[3], grid, smem, st,
                 p);
  }
}

template <typename T>
cudaError_t launch_grouped(const Params& p, int grid, int smem,
                           cudaStream_t st) {
  return p.s == 1 ? launch_grouped_s<T, 1>(p, grid, smem, st)
                  : launch_grouped_s<T, 2>(p, grid, smem, st);
}

// The arguments both entries share, up to the tile.
Params common(const void* x, long long sb, long long sc, long long sh,
              long long sw, const void* w8, const void* s_in, const void* s_w,
              const void* gamma, const void* beta, const void* mean,
              const void* var, float eps, void* out, int B, int Cin, int H,
              int W, int Cout, int kh, int kw, int stride, int pad_h,
              int pad_w, int Ho, int Wo, int act, int epilogue, int th,
              int tw) {
  Params p;
  p.x = x;
  p.sb = sb;
  p.sc = sc;
  p.sh = sh;
  p.sw = sw;
  p.w8 = static_cast<const int8_t*>(w8);
  p.s_in = static_cast<const float*>(s_in);
  p.s_w = static_cast<const float*>(s_w);
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.mean = static_cast<const float*>(mean);
  p.var = static_cast<const float*>(var);
  p.eps = eps;
  p.out = out;
  p.Cin = Cin;
  p.H = H;
  p.W = W;
  p.Cout = Cout;
  p.kh = kh;
  p.kw = kw;
  p.s = stride;
  p.ph = pad_h;
  p.pw = pad_w;
  p.Ho = Ho;
  p.Wo = Wo;
  p.th = th;
  p.tw = tw;
  p.hh = (th - 1) * stride + kh;
  p.hw = (tw - 1) * stride + kw;
  p.tiles_w = (Wo + tw - 1) / tw;
  p.tiles_h = (Ho + th - 1) / th;
  p.tiles = B * p.tiles_w * p.tiles_h;
  p.act = act;
  p.epi = epilogue;
  return p;
}

}  // namespace

// The "stem" path. The arguments of icaf_conv_int8 up to epilogue, then
// kernels/conv_int8.py: plan()'s tile (th, tw), the grid of persistent
// blocks and the dynamic shared memory a block, which must hold what this
// entry lays out (plan(): stem_smem). groups 1; stride 1 or 2 in both
// dimensions; Cout % 8 == 0; at most kItemsMax window values a thread.
extern "C" int icaf_conv_int8_stem(
    const void* x, long long sb, long long sc, long long sh, long long sw,
    const void* w8, const void* s_in, const void* s_w, const void* gamma,
    const void* beta, const void* mean, const void* var, float eps,
    void* out, int B, int Cin, int H, int W, int Cout, int kh, int kw,
    int stride_h, int stride_w, int pad_h, int pad_w, int Ho, int Wo,
    int is_bf16, int act, int epilogue, int th, int tw, int grid, int smem,
    void* stream) {
  if (B == 0 || Cout == 0) return cudaSuccess;
  if (stride_h != stride_w || (stride_h != 1 && stride_h != 2) ||
      Cout % 8 || Cin < 1 || Cin > kStemThreads || th < 1 || tw < 1 ||
      th * tw > kSlots || grid < 1 || reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  Params p = common(x, sb, sc, sh, sw, w8, s_in, s_w, gamma, beta, mean, var,
                    eps, out, B, Cin, H, W, Cout, kh, kw, stride_h, pad_h,
                    pad_w, Ho, Wo, act, epilogue, th, tw);
  const int esz = epilogue ? (is_bf16 ? 2 : 4) : 4;
  p.Lp = round16(static_cast<long long>(p.hw) * Cin);
  p.Gr = (kw * Cin + 3) / 4;
  p.steps = (kh * p.Gr + 7) / 8;
  p.KP = p.steps * 32 + 16;
  p.pitch = (kNC + 8) * esz;
  p.off_w = round16(8LL * Cout);
  p.off_tab = p.off_w + round16(static_cast<long long>(Cout) * p.KP);
  p.off_win = p.off_tab + p.steps * 32;
  p.off_stage = p.off_win + round16(static_cast<long long>(p.hh) * p.Lp + 64);
  const long long need = p.off_stage + static_cast<long long>(kSlots) * p.pitch;
  const int per = kStemThreads / Cin;
  const int items = (p.hh * p.hw + per - 1) / per;
  if (need > smem || smem > kSmemMax || items > kItemsMax)
    return cudaErrorInvalidValue;
  if (grid > p.tiles) grid = p.tiles;
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_stem<__nv_bfloat16>(p, items, grid, smem, st)
                 : launch_stem<float>(p, items, grid, smem, st);
}

// The "grouped" path: the arguments of icaf_conv_int8 up to groups, then
// plan()'s tile (th, tw; tw a multiple of 4), groups a block (gpc) and the
// dynamic shared memory a block (plan(): grouped_smem). Stride 1 or 2 in
// both dimensions; kw 1, 3, 5 or 7; at most 256 channels a block in and
// out.
extern "C" int icaf_conv_int8_grouped(
    const void* x, long long sb, long long sc, long long sh, long long sw,
    const void* w8, const void* s_in, const void* s_w, const void* gamma,
    const void* beta, const void* mean, const void* var, float eps,
    void* out, int B, int Cin, int H, int W, int Cout, int kh, int kw,
    int stride_h, int stride_w, int pad_h, int pad_w, int Ho, int Wo,
    int is_bf16, int act, int epilogue, int groups, int th, int tw, int gpc,
    int smem, void* stream) {
  if (B == 0 || Cout == 0) return cudaSuccess;
  if (groups < 1 || Cin % groups || Cout % groups || gpc < 1 ||
      gpc > groups || stride_h != stride_w ||
      (stride_h != 1 && stride_h != 2) ||
      (kw != 1 && kw != 3 && kw != 5 && kw != 7) || th < 1 || tw < kR ||
      tw % kR)
    return cudaErrorInvalidValue;
  Params p = common(x, sb, sc, sh, sw, w8, s_in, s_w, gamma, beta, mean, var,
                    eps, out, B, Cin, H, W, Cout, kh, kw, stride_h, pad_h,
                    pad_w, Ho, Wo, act, epilogue, th, tw);
  p.Cin_g = Cin / groups;
  p.Cout_g = Cout / groups;
  p.groups = groups;
  p.gpc = gpc;
  p.chunks = (groups + gpc - 1) / gpc;
  const int cinb = gpc * p.Cin_g, coutb = gpc * p.Cout_g;
  if (cinb > kThreads || coutb > kThreads) return cudaErrorInvalidValue;
  const int esz = epilogue ? (is_bf16 ? 2 : 4) : 4;
  const int xsz = is_bf16 ? 2 : 4;
  p.vec = sc == 1 && (sb * xsz) % 16 == 0 && (sh * xsz) % 16 == 0 &&
          (sw * xsz) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.pitch = round16(static_cast<long long>(coutb) * esz);
  p.off_w = round16(8LL * coutb);
  p.off_win =
      p.off_w + round16(static_cast<long long>(kh) * kw * p.Cin_g * coutb);
  p.off_stage =
      p.off_win + round16(static_cast<long long>(p.hh) * p.hw * cinb);
  const long long need =
      p.off_stage + static_cast<long long>(th) * tw * p.pitch;
  if (need > smem || smem > kSmemMax) return cudaErrorInvalidValue;
  const long long grid = static_cast<long long>(p.tiles) * p.chunks;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? launch_grouped<__nv_bfloat16>(p, static_cast<int>(grid), smem,
                                             st)
             : launch_grouped<float>(p, static_cast<int>(grid), smem, st);
}
