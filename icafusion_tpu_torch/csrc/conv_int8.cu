// int8 W8A8 convolution with its input quantization, dequantization,
// eval-mode BatchNorm and SiLU (or identity) in one launch:
//
//   x8[b, ci, h, w] = clip(rn(x[b, ci, h, w] / s_in[ci]), -127, 127)
//   acc[b, co, ho, wo] = sum_{ky, kx, ci} x8[b, ci, ho*sh - ph + ky,
//                                          wo*sw - pw + kx] w8[co, ky, kx, ci]
//   out = act(acc * mult[co] + add[co]),
//   mult = s_w * gamma / sqrt(var + eps),  add = beta - mean * gamma / sqrt(..)
//
// accumulated exactly in int32 (|acc| <= 127^2 * K < 2^31 for every
// K = kh*kw*Cin up to 11520 of the shipped configs), x fp32 or bf16 in any
// strides (channels_last on the serving path), out channels_last in x's
// dtype, or the raw int32 accumulators (epilogue = 0).
//
// Replaces no Pallas kernel: the JAX package's int8 conv is XLA's
// (icafusion_tpu/nn/layers.py:154-176, Conv._int8_conv,
// lax.conv_general_dilated on int8 operands with an int32 result), and
// PyTorch has no int8 convolution on CUDA. The quantization matches the JAX
// code bit for bit: an IEEE fp32 division (this file is built without
// --use_fast_math, and uses __fdiv_rn all the same), then round half to
// even (__float2int_rn, as jnp.round), then the clamp; quantize_n takes a
// product with the reciprocal where that provably rounds to the same
// integer and the division elsewhere. The epilogue is
// fp32 with explicit _rn operations (no FMA contraction), rounded once to
// the output dtype, so it equals the plain version's fp32 arithmetic.
//
// What bounds it on the H100: a yolov5l-Transfusion forward at 640 is about
// 91 GMAC an image, 0.09 ms an image at the 1979 TOPS int8 dense peak; the
// 3x3 convs of P4/P5 are operation-bound, the 1x1 convs and the stem
// byte-bound. So the input must be read and quantized about once, and the
// products must run on wgmma.
//
// Four paths; kernels/conv_int8.py: plan() picks one from dtype, strides,
// groups, Cin and Cout, and the wrapper launches it or raises. Two are
// here, "tma" and "direct"; "stem" (dense convs with Cin % 16 != 0: the
// stems) and "grouped" (groups > 1) are in conv_int8_small.cu. The
// arithmetic all four share is in conv_int8.cuh.
//
// "tma" (conv_int8_tma_kernel), the serving path: x bf16 or fp32 with its
// channels innermost and 16-byte pixel strides (channels_last, or a
// channels_last view with a 16-byte aligned channel offset), Cin % 16 == 0,
// Cout % 8 == 0, stride 1 or 2: every int8 conv of every CSPDarknet scale
// but the stem. (The name is its weight path's: x is read by the threads.)
//   - a block owns th x tw output pixels of one image (its 128 wgmma rows,
//     two consumer warpgroups of 64) and has one producer warp;
//   - the consumers read the tile's input window with its halo,
//     ((th-1)*s + kh) x ((tw-1)*s + kw) pixels, straight from x, 16 bytes
//     of a pixel's channels a load and 4 or 8 loads in flight a thread;
//     a pixel outside x reads as zero, and rn(0 / s) = 0, so that is the
//     conv's zero padding in the x8 domain. First design: TMA loads of
//     the window in bands through a two-stage ring; on the H100 each band
//     waited out a ~1.5 us round trip (per-block timestamps, PERF.md), and
//     a deeper ring did not fit beside the window copies;
//   - they quantize each element once (IEEE division, as below, with an
//     exact fast path) into int8 copies of the window in shared memory,
//     one for each tap column kx and row parity py = ky % s: copy (kx, py)
//     row j * tw + c holds window pixel (j * s + py, c * s + kx), 128
//     channels a 128-byte row, 16-byte chunk c of row r at (c ^ (r & 7)):
//     the 128-byte swizzle. Tap (ky, kx) of the tile's 128 pixels (slot
//     i = r * tw + c) is then rows (ky / s) * tw + i of copy (kx, ky % s):
//     64 consecutive rows a warpgroup, a K-major operand that wgmma reads
//     through a descriptor (tw is a multiple of 8, so the rows start on a
//     swizzle atom). Every tap and every output-channel tile of the block
//     reads the copies;
//   - products: wgmma m64n128k32 s32.s8.s8 from shared memory, one stage's
//     products in flight while the next is issued. B, w8 viewed as a 3-D
//     map (Cin, kh*kw, Cout), streams through a TMA ring of 2 to 4
//     swizzled 128 x 128-byte tiles with mbarriers, one (tap, 128-channel
//     chunk) a tile, filled by the producer warp. The map zero-fills past
//     Cin, so the last k32 step of Cin 16, 48 or 80 multiplies the
//     window's unwritten channels by zeros;
//   - a block covers ceil(Cout / 128) / groups output tiles on the same
//     quantized window. Where the output tiles leave SMs idle, they are
//     spread over `groups` blocks and Cin over `splits` blocks of
//     32-channel units (plan() says how many and why); each split writes
//     its int32 partial to a scratch, and the last block to arrive at a
//     tile (a per-tile counter, which it resets) sums them - int32 sums are
//     exact in any order - and applies the epilogue;
//   - epilogue from registers: quad shuffles so that a thread stores 16
//     bytes of consecutive channels of one pixel.
//   Two blocks share an SM where shared memory allows (96 registers a
//   thread; -Xptxas -v in chip_smoke.py phase 1 reports each variant).
//
// "direct" (conv_int8_kernel), the first design, kept for what the other
// three do not take: NCHW or misaligned maps with Cin >= 16, strides other
// than 1 or 2, Cout % 8 != 0, and grouped convs with kw outside {1, 3, 5,
// 7} or a group of more than 256 channels: an implicit GEMM, M =
// B*Ho*Wo output pixels, N = Cout, K = kh*kw*Cin_g in (ky, kx, ci) order
// (w8's own order, so B rows are w8's rows). With g groups, Cin_g = Cin / g
// and output channel co reads input channels [(co / Cout_g) * Cin_g, ... +
// Cin_g), Cout_g = Cout / g: a block's 128 output channels lie in one group
// (blockIdx.y counts ceil(Cout_g / 128) tiles a group), so a depthwise conv
// uses one of its 128 columns. Simple and exact, not fast. A block
// computes a 64-pixel x 128-channel tile
// with 8 warps (2 x 4, 32 x 32 each: 2 x 4 m16n8k32 tiles), stepping K by
// 64 bytes through two shared-memory buffers: the global loads of step k+1
// are issued before the products of step k and stored (A quantized on the
// way) after them, one barrier a step. A thread loads one K column of A
// for 16 pixels (a warp reads 32 consecutive channels of a pixel:
// coalesced in channels_last), and two 16-byte chunks of B (byte loads
// where K is not a multiple of 16). Rows are 80 bytes apart in shared
// memory, which makes the fragment loads free of bank conflicts. It
// quantizes every input element once per tap and per 128 output channels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "conv_int8.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using namespace icaf_int8;

constexpr int kBM = 64;           // output pixels a block
constexpr int kBN = 128;          // output channels a block
constexpr int kBK = 64;           // K bytes a step
constexpr int kThreads = 256;
constexpr int kRow = kBK + 16;    // shared row pitch in bytes
constexpr int kARows = kThreads / kBK;        // 4 pixel rows per pass
constexpr int kAPerThread = kBM / kARows;     // 16 A values a thread a step
constexpr int kBChunks = kBN * kBK / 16 / kThreads;   // 2 chunks a thread
constexpr int kInvalid = -(1 << 28);          // row origin past M

struct Params {
  const void* x;
  long long sb, sc, sh, sw;      // x's element strides (b, c, h, w)
  const int8_t* w8;              // (Cout, kh, kw, Cin)
  const float* s_in;             // (Cin,)
  const float* s_w;              // (Cout,)
  const float* gamma;
  const float* beta;
  const float* mean;
  const float* var;
  float eps;
  void* out;                     // (B, Ho, Wo, Cout): channels_last
  int Cin, H, W, Cout, kw, stride_h, stride_w, pad_h, pad_w, Ho, Wo;
  int M, K;
  int Cin_g, Cout_g, n_tiles_g;  // channels a group in and out, tiles a group
  int act;                       // 1: SiLU, 0: identity
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, bool kEpilogue>
__global__ void __launch_bounds__(kThreads)
    conv_int8_kernel(const Params p) {
  __shared__ __align__(16) int8_t As[2][kBM * kRow];
  __shared__ __align__(16) int8_t Bs[2][kBN * kRow];
  __shared__ long long row_off[kBM];   // x offset of the window's origin
  __shared__ int row_h[kBM], row_w[kBM];
  __shared__ float col_mult[kBN], col_add[kBN];

  const int tid = threadIdx.x;
  const int grp = blockIdx.y / p.n_tiles_g;
  const int m0 = blockIdx.x * kBM;
  const int n0 = grp * p.Cout_g + (blockIdx.y % p.n_tiles_g) * kBN;
  const int n_end = min(p.Cout, (grp + 1) * p.Cout_g);  // the group's end
  const int ci0 = grp * p.Cin_g;                         // its first input
  if (tid < kBM) {
    const int m = m0 + tid;
    if (m < p.M) {
      const int wo = m % p.Wo, t = m / p.Wo;
      const int ho = t % p.Ho, b = t / p.Ho;
      const int h0 = ho * p.stride_h - p.pad_h, w0 = wo * p.stride_w - p.pad_w;
      row_h[tid] = h0;
      row_w[tid] = w0;
      row_off[tid] = b * p.sb + h0 * p.sh + w0 * p.sw;
    } else {
      row_h[tid] = kInvalid;
      row_w[tid] = kInvalid;
      row_off[tid] = 0;
    }
  }
  if (kEpilogue && tid < kBN) {
    const int n = n0 + tid;
    float mult = 0.f, add = 0.f;
    if (n < n_end) {
      const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(p.var[n], p.eps)));
      const float g = __fmul_rn(p.gamma[n], inv);
      mult = __fmul_rn(p.s_w[n], g);
      add = __fsub_rn(p.beta[n], __fmul_rn(p.mean[n], g));
    }
    col_mult[tid] = mult;
    col_add[tid] = add;
  }
  __syncthreads();

  const T* __restrict__ x = static_cast<const T*>(p.x);
  const int a_col = tid % kBK, a_row = tid / kBK;
  const bool b_vec = (p.K % 16) == 0;
  const int KT = (p.K + kBK - 1) / kBK;

  float a_val[kAPerThread];
  float a_scale = 1.f, a_rcp = 1.f;
  uint4 b_val[kBChunks];

  auto load = [&](int kt) {
    const int k = kt * kBK + a_col;
    if (k < p.K) {
      const int ci = ci0 + k % p.Cin_g, tap = k / p.Cin_g;
      const int kx = tap % p.kw, ky = tap / p.kw;
      const long long col_off = ci * p.sc + ky * p.sh + kx * p.sw;
      a_scale = p.s_in[ci];
      a_rcp = __frcp_rn(a_scale);
#pragma unroll
      for (int i = 0; i < kAPerThread; ++i) {
        const int r = a_row + i * kARows;
        const int h = row_h[r] + ky, w = row_w[r] + kx;
        a_val[i] = (h >= 0 && h < p.H && w >= 0 && w < p.W)
                       ? to_float(x[row_off[r] + col_off])
                       : 0.f;
      }
    } else {
      a_scale = a_rcp = 1.f;
#pragma unroll
      for (int i = 0; i < kAPerThread; ++i) a_val[i] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBChunks; ++j) {
      const int chunk = tid + j * kThreads;
      const int n = n0 + chunk / (kBK / 16);
      const int k0 = kt * kBK + (chunk % (kBK / 16)) * 16;
      const int8_t* row = p.w8 + static_cast<long long>(n) * p.K;
      if (b_vec) {
        b_val[j] = (n < n_end && k0 < p.K)
                       ? *reinterpret_cast<const uint4*>(row + k0)
                       : make_uint4(0, 0, 0, 0);
      } else {
        uint32_t v[4] = {0, 0, 0, 0};
        if (n < n_end) {
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const int k = k0 + e;
            const uint32_t byte =
                k < p.K ? static_cast<uint8_t>(row[k]) : 0u;
            v[e >> 2] |= byte << ((e & 3) * 8);
          }
        }
        b_val[j] = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  };

  auto stash = [&](int buf) {
    int q[kAPerThread];
    quantize_n(a_val, [&](int) { return a_scale; }, [&](int) { return a_rcp; },
               q);
#pragma unroll
    for (int i = 0; i < kAPerThread; ++i) {
      const int r = a_row + i * kARows;
      As[buf][r * kRow + a_col] = static_cast<int8_t>(q[i]);
    }
#pragma unroll
    for (int j = 0; j < kBChunks; ++j) {
      const int chunk = tid + j * kThreads;
      const int n = chunk / (kBK / 16), q = chunk % (kBK / 16);
      *reinterpret_cast<uint4*>(&Bs[buf][n * kRow + q * 16]) = b_val[j];
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 4) * 32, wn = (warp % 4) * 32;
  const int g = lane >> 2, t4 = (lane & 3) * 4;
  int acc[2][4][4] = {};

  load(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < KT) load(kt + 1);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* base = &As[cur][(wm + i * 16 + g) * kRow + kk + t4];
        a[i][0] = *reinterpret_cast<const uint32_t*>(base);
        a[i][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kRow);
        a[i][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kRow + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* base = &Bs[cur][(wn + j * 8 + g) * kRow + kk + t4];
        b[j][0] = *reinterpret_cast<const uint32_t*>(base);
        b[j][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8_16832(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    if (kt + 1 < KT) stash(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = wm + i * 16 + g + (r >= 2 ? 8 : 0);
        const int col = wn + j * 8 + (lane & 3) * 2 + (r & 1);
        const int m = m0 + row, n = n0 + col;
        if (m >= p.M || n >= n_end) continue;
        const long long o = static_cast<long long>(m) * p.Cout + n;
        if (kEpilogue) {
          float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][r]),
                                        col_mult[col]),
                              col_add[col]);
          if (p.act) y = __fdiv_rn(y, __fadd_rn(1.f, expf(-y)));
          store(static_cast<T*>(p.out) + o, y);
        } else {
          static_cast<int*>(p.out)[o] = acc[i][j][r];
        }
      }
}

template <typename T>
cudaError_t launch(const Params& p, int epilogue, cudaStream_t st) {
  const dim3 grid((p.M + kBM - 1) / kBM,
                  (p.Cout / p.Cout_g) * p.n_tiles_g);
  if (epilogue)
    conv_int8_kernel<T, true><<<grid, kThreads, 0, st>>>(p);
  else
    conv_int8_kernel<T, false><<<grid, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

// ===========================================================================
// "tma": quantize once a block, s8 wgmma, TMA weight tiles, split-K
// ===========================================================================

namespace tma {

constexpr int kSlots = 128;        // output pixels a block: 2 warpgroups x 64
constexpr int kN = 128;            // output channels a wgmma tile
constexpr int kQ = 128;            // int8 channels a window row (bytes)
constexpr int kBStagesMax = 4;     // weight tiles in flight (plan: 2 to 4)
constexpr int kBStage = kN * kQ;   // one (tap, 128-channel chunk) tile
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;   // and the producer warp
constexpr int kSmemMax = 232448;

struct Params {
  const void* x;
  long long sb, sh_, sw_;    // x's element strides (b, h, w); c's is 1
  const float* s_in;
  const float* s_w;
  const float* gamma;
  const float* beta;
  const float* mean;
  const float* var;
  float eps;
  void* out;                 // (B, Ho, Wo, Cout)
  int* ws;                   // (splits, B, Ho, Wo, Cout) int32 partials
  int* counters;             // (tiles * groups,), zero between launches
  long long out_elems;       // B * Ho * Wo * Cout
  int Cin, Cout, kh, kw, sh, ph, pw, Ho, Wo;   // sh: both strides
  int th, tw, hh, hw, tiles_w, tiles_h, H, W;
  int groups, npg, n_tiles, splits, slice_units;
  int b_stages;              // the weight ring's tiles
  int act;
  // shared memory, from the 1 KB-aligned base: weight ring at 0
  uint32_t off_q, chunk_bytes, copy_bytes, off_ep, off_bar;
};

// The warp's 16 accumulator rows (pixels pix[0] for rows qg, pix[1] for
// qg + 8; -1 where dropped) of one 128-channel tile, as 4-byte values
// val(i) of acc[i]: in each 8-channel group the lane pair (qt, qt ^ 1)
// swaps halves, so that the even lane stores 4 channels of row qg and the
// odd one 4 channels of row qg + 8, 16 bytes each.
template <typename F>
__device__ __forceinline__ void store_4b(uint32_t* dst, const long long (&pix)[2],
                                         int Cout, int n0, int qt, F val) {
  const bool odd = qt & 1;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (n0 + 8 * j >= Cout) break;   // the tile runs past Cout
    const uint32_t v00 = val(4 * j), v01 = val(4 * j + 1);
    const uint32_t v10 = val(4 * j + 2), v11 = val(4 * j + 3);
    const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? v00 : v10, 1);
    const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? v01 : v11, 1);
    const long long px = pix[odd];
    const int n = n0 + 8 * j + 2 * (qt & 2);
    if (px >= 0 && n < Cout)
      *reinterpret_cast<uint4*>(dst + px * Cout + n) =
          odd ? make_uint4(r0, r1, v10, v11) : make_uint4(v00, v01, r0, r1);
  }
}

// The same as bf16: a quad transpose per 64-channel half, so that lane qt
// stores channels 16 qt .. 16 qt + 15 of each half of each row.
template <typename F>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* dst,
                                           const long long (&pix)[2], int Cout,
                                           int n0, int qt, F val) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      if (n0 + 64 * g >= Cout) break;   // the tile runs past Cout
      uint32_t word[8];   // channels 64 g + 8 jj + 2 qt, +1
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int i = 4 * (8 * g + jj) + 2 * h;
        word[jj] = pack_bf16(val(i), val(i + 1));
      }
      uint32_t r[4][2];   // r[k][i]: lane qt ^ k's word[2 qt + i]
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          r[k][i] = __shfl_xor_sync(
              0xffffffffu,
              pick4(word[i], word[2 + i], word[4 + i], word[6 + i], qt ^ k), k);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int n = n0 + 64 * g + 16 * qt + 8 * i;
        if (pix[h] >= 0 && n < Cout)
          *reinterpret_cast<uint4*>(dst + pix[h] * Cout + n) =
              make_uint4(pick4(r[0][i], r[1][i], r[2][i], r[3][i], qt),
                         pick4(r[0][i], r[1][i], r[2][i], r[3][i], qt ^ 1),
                         pick4(r[0][i], r[1][i], r[2][i], r[3][i], qt ^ 2),
                         pick4(r[0][i], r[1][i], r[2][i], r[3][i], qt ^ 3));
      }
    }
}

// What the product loop of a block needs to find its operands.
struct Stage {
  uint32_t sq, base, bars;      // window copies, weight ring, barriers
  uint32_t chunk_bytes, copy_bytes;
  int nk, cw, kw, sh, tw, row0, lane, b_stages;   // nk: 128-channel chunks
};

// Stage st = (tap, 128-channel chunk) of an output tile, on weight ring
// position it: wait for its weights and issue its k32 steps (the first of
// the tile overwrites acc). A is the warpgroup's 64 rows of the window copy
// of the tap, a K-major swizzled operand read through a descriptor. Then
// wait for the previous stage's products and release that stage's
// weights, so that one stage's products run while the next is issued.
__device__ __forceinline__ void step(const Stage& c, int (&acc)[64], int st,
                                     int it) {
  const int k = st % c.nk, tap = st / c.nk;
  const int ky = tap / c.kw, kx = tap % c.kw;
  const int ks = min(4, (c.cw - k * kQ + 31) / 32);
  const int s = it % c.b_stages;
  mbar_wait(c.bars + 8 * s, (it / c.b_stages) & 1);
  const uint32_t a = c.sq + k * c.chunk_bytes +
                     (kx * c.sh + ky % c.sh) * c.copy_bytes +
                     (c.row0 + (ky / c.sh) * c.tw) * kQ;
  const uint32_t b = c.base + s * kBStage;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    if (kk < ks)
      wgmma_m64n128k32_s8_ss(acc, desc_sw128(a + kk * 32),
                             desc_sw128(b + kk * 32), (st | kk) != 0);
  wgmma_commit();
  wgmma_wait<1>();
  __syncwarp();
  if (st > 0 && c.lane == 0)
    mbar_arrive(c.bars + 8 * (kBStagesMax + (it - 1) % c.b_stages));
}

// kEpi: the epilogue (else the raw int32 sums); kS: the stride (1 or 2).
template <typename T, bool kEpi, int kS>
__global__ void __launch_bounds__(kThreads, 2)
    conv_int8_tma_kernel(const __grid_constant__ CUtensorMap wmap,
                         const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t base = (raw0 + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw0);
  const uint32_t sq = base + p.off_q;
  float* ep = reinterpret_cast<float*>(sm + p.off_ep);   // mult, then add
  // barriers: weights full 0-3, empty 4-7
  const uint32_t bars = base + p.off_bar;
  int* flag = reinterpret_cast<int*>(sm + p.off_bar + 2 * kBStagesMax * 8);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int bid = blockIdx.x;
  const int split = bid % p.splits;
  bid /= p.splits;
  const int group = bid % p.groups, tile = bid / p.groups;
  const int w0 = (tile % p.tiles_w) * p.tw;
  const int h0 = (tile / p.tiles_w % p.tiles_h) * p.th;
  const int b = tile / (p.tiles_w * p.tiles_h);
  const int c_lo = split * p.slice_units * 32;
  const int cw = min(p.Cin, c_lo + p.slice_units * 32) - c_lo;
  const int nk = (cw + kQ - 1) / kQ;             // 128-channel chunks
  const int nt0 = group * p.npg, nt1 = min(p.n_tiles, nt0 + p.npg);
  const int taps = p.kh * p.kw, stages = taps * nk;

  if (tid == 0) {
    for (int i = 0; i < kBStagesMax; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (kBStagesMax + i), kConsumers / 32);
    }
    mbar_init_fence();
  }
  if (kEpi && tid < kConsumers) {
    for (int c = tid; c < (nt1 - nt0) * kN; c += kConsumers) {
      const int n = nt0 * kN + c;
      float mult = 0.f, add = 0.f;
      if (n < p.Cout) {
        const float inv =
            __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(p.var[n], p.eps)));
        const float g = __fmul_rn(p.gamma[n], inv);
        mult = __fmul_rn(p.s_w[n], g);
        add = __fsub_rn(p.beta[n], __fmul_rn(p.mean[n], g));
      }
      ep[c] = mult;
      ep[p.npg * kN + c] = add;
    }
  }
  __syncthreads();

  if (warp == kConsumers / 32) {   // the producer: the weight tiles
    if (lane == 0) {
      tma_prefetch_map(&wmap);
      int it = 0;
      for (int nt = nt0; nt < nt1; ++nt)
        for (int tap = 0; tap < taps; ++tap)
          for (int k = 0; k < nk; ++k, ++it) {
            const int s = it % p.b_stages;
            mbar_wait(bars + 8 * (kBStagesMax + s),
                      ((it / p.b_stages) & 1) ^ 1);
            mbar_expect_tx(bars + 8 * s, kBStage);
            tma_load_3d(base + s * kBStage, &wmap, bars + 8 * s,
                        c_lo + k * kQ, tap, nt * kN);
          }
    }
    return;
  }

  // 1. Quantize the window once, straight from x (L2 holds the halos
  // that neighbouring tiles share). A thread takes 8 channels (16 or 32
  // bytes) of a pixel an item, kUnroll pixels at a time so that their
  // loads are in flight together; GP threads cover a pixel's channels.
  const int wg = warp >> 2;
  {
    constexpr int kUnroll = 16 / sizeof(T);   // 8 bf16 or 4 fp32 items
    const T* __restrict__ x = static_cast<const T*>(p.x);
    const int groups8 = cw / 8;   // Cin % 16 == 0
    int gp = 1;
    while (gp < groups8 && gp < 32) gp <<= 1;
    const int pstep = kConsumers / gp, npx = p.hh * p.hw;
    const int hi0 = h0 * kS - p.ph, wi0 = w0 * kS - p.pw;
    const long long xb = static_cast<long long>(b) * p.sb;
    for (int g = tid % gp; g < groups8; g += gp) {
      const int cb = g * 8;   // channel in the slice
      const int ci = c_lo + cb;
      float sc[8], rc[8];   // scalar loads: s_in need not be 16-byte aligned
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sc[e] = __ldg(p.s_in + ci + e);
        rc[e] = __frcp_rn(sc[e]);
      }
      const int col = cb & (kQ - 1);
      const uint32_t dst = p.off_q + (cb / kQ) * p.chunk_bytes + (col & 8);
      const int chunk16 = col >> 4;
      for (int px0 = tid / gp; px0 < npx; px0 += pstep * kUnroll) {
        Raw8<T> w[kUnroll];
        int wr[kUnroll], wc[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int px = px0 + u * pstep;
          wr[u] = px / p.hw;
          wc[u] = px - wr[u] * p.hw;
          const int h = hi0 + wr[u], ww = wi0 + wc[u];
          const bool ok = px < npx && h >= 0 && h < p.H && ww >= 0 && ww < p.W;
          load8(x + xb + h * p.sh_ + ww * p.sw_ + ci, ok, w[u]);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (px0 + u * pstep >= npx) break;
          float v[8];
          unpack8(w[u], v);
          uint32_t q8[2];
          quantize8(v, sc, rc, q8);
          // into copy (kx, wr % kS), row (wr / kS) * tw + j, of every tap
          // column kx that reads it: window column wc = j * kS + kx
          const uint32_t row_base = dst + (wr[u] % kS) * p.copy_bytes;
          const int row = (wr[u] / kS) * p.tw;
          for (int kx = 0; kx < p.kw && kx <= wc[u]; ++kx) {
            const int t = wc[u] - kx, j = t / kS;
            if (t % kS || j >= p.tw) continue;
            const int R = row + j;
            *reinterpret_cast<uint2*>(
                sm + row_base + kx * kS * p.copy_bytes + R * kQ +
                ((chunk16 ^ (R & 7)) << 4)) = make_uint2(q8[0], q8[1]);
          }
        }
      }
    }
  }
  fence_proxy_async();   // the copies are wgmma operands
  named_barrier(1, kConsumers);

  // 2. Products, one 128-channel output tile after another.
  const int row0 = wg * 64 + (warp & 3) * 16;   // the warp's first slot
  const int slots = p.th * p.tw;
  Stage stg;
  stg.sq = sq;
  stg.base = base;
  stg.bars = bars;
  stg.chunk_bytes = p.chunk_bytes;
  stg.copy_bytes = p.copy_bytes;
  stg.nk = nk;
  stg.cw = cw;
  stg.kw = p.kw;
  stg.sh = p.sh;
  stg.tw = p.tw;
  stg.row0 = wg * 64;
  stg.lane = lane;
  stg.b_stages = p.b_stages;

  const int qg = lane >> 2, qt = lane & 3;
  long long pix[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int sl = row0 + qg + 8 * h;
    const int ho = h0 + sl / p.tw, wo = w0 + sl % p.tw;
    pix[h] = (sl < slots && ho < p.Ho && wo < p.Wo)
                 ? (static_cast<long long>(b) * p.Ho + ho) * p.Wo + wo
                 : -1;
  }

  int acc[64];
  int it = 0;   // the weight ring's position
  for (int nt = nt0; nt < nt1; ++nt) {
    for (int st = 0; st < stages; ++st) step(stg, acc, st, it++);
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0)
      mbar_arrive(bars + 8 * (kBStagesMax + (it - 1) % p.b_stages));

    const int n0 = nt * kN;
    const float* mult = ep + (nt - nt0) * kN;
    const float* add = mult + p.npg * kN;
    auto raw = [&](int i) { return static_cast<uint32_t>(acc[i]); };
    if (p.splits > 1) {
      store_4b(reinterpret_cast<uint32_t*>(p.ws) + split * p.out_elems, pix,
               p.Cout, n0, qt, raw);
    } else if (!kEpi) {
      store_4b(static_cast<uint32_t*>(p.out), pix, p.Cout, n0, qt, raw);
    } else {
      auto val = [&](int i) {   // acc[i]: channel 8 (i / 4) + 2 qt + (i & 1)
        const int c = 8 * (i >> 2) + 2 * qt + (i & 1);
        return epilogue(acc[i], mult[c], add[c], p.act);
      };
      if constexpr (sizeof(T) == 2)
        store_bf16(static_cast<__nv_bfloat16*>(p.out), pix, p.Cout, n0, qt,
                   val);
      else
        store_4b(static_cast<uint32_t*>(p.out), pix, p.Cout, n0, qt,
                 [&](int i) { return __float_as_uint(val(i)); });
    }
  }
  if (p.splits == 1) return;

  // 3. Split-K: the last block to arrive at the tile sums the partials.
  __threadfence();
  named_barrier(1, kConsumers);
  if (tid == 0) {
    int* counter = p.counters + tile * p.groups + group;
    const int last = atomicAdd(counter, 1) == p.splits - 1;
    if (last) *counter = 0;   // ready for the next launch
    *flag = last;
  }
  named_barrier(1, kConsumers);
  if (!*flag) return;
  __threadfence();
  const int groups8 = (nt1 - nt0) * kN / 8;
  for (int i = tid; i < slots * groups8; i += kConsumers) {
    const int sl = i / groups8, c = (i % groups8) * 8;   // c: in the group
    const int ho = h0 + sl / p.tw, wo = w0 + sl % p.tw;
    const int n = nt0 * kN + c;
    if (ho >= p.Ho || wo >= p.Wo || n >= p.Cout) continue;
    const long long o =
        ((static_cast<long long>(b) * p.Ho + ho) * p.Wo + wo) * p.Cout + n;
    int sum[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int s = 0; s < p.splits; ++s) {
      const int4* src = reinterpret_cast<const int4*>(p.ws + s * p.out_elems + o);
      const int4 lo = __ldcg(src), hi = __ldcg(src + 1);
      sum[0] += lo.x; sum[1] += lo.y; sum[2] += lo.z; sum[3] += lo.w;
      sum[4] += hi.x; sum[5] += hi.y; sum[6] += hi.z; sum[7] += hi.w;
    }
    if (!kEpi) {
      int4* dst = reinterpret_cast<int4*>(static_cast<int*>(p.out) + o);
      dst[0] = make_int4(sum[0], sum[1], sum[2], sum[3]);
      dst[1] = make_int4(sum[4], sum[5], sum[6], sum[7]);
      continue;
    }
    float y[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      y[e] = epilogue(sum[e], ep[c + e], ep[p.npg * kN + c + e], p.act);
    if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.out) + o) =
          make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]),
                     pack_bf16(y[4], y[5]), pack_bf16(y[6], y[7]));
    } else {
      float4* dst = reinterpret_cast<float4*>(static_cast<float*>(p.out) + o);
      dst[0] = make_float4(y[0], y[1], y[2], y[3]);
      dst[1] = make_float4(y[4], y[5], y[6], y[7]);
    }
  }
}

template <typename T, bool kEpi, int kS>
cudaError_t launch_kernel(const CUtensorMap& wmap, const Params& p, int grid,
                          int smem, cudaStream_t st) {
  static bool opted[kMaxDevices];
  auto kernel = conv_int8_tma_kernel<T, kEpi, kS>;
  cudaError_t err = opt_in_smem(kernel, kSmemMax, opted);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(wmap, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_epi(const CUtensorMap& wmap, const Params& p, int grid,
                       int smem, int epi, cudaStream_t st) {
  if (p.sh == 1)
    return epi ? launch_kernel<T, true, 1>(wmap, p, grid, smem, st)
               : launch_kernel<T, false, 1>(wmap, p, grid, smem, st);
  return epi ? launch_kernel<T, true, 2>(wmap, p, grid, smem, st)
             : launch_kernel<T, false, 2>(wmap, p, grid, smem, st);
}

}  // namespace tma

}  // namespace

// x with element strides (sb, sc, sh, sw); w8 (Cout, kh, kw, Cin / groups)
// int8; s_in (Cin,), s_w and the BatchNorm's gamma, beta, mean, var (Cout,)
// float32; out (B, Ho, Wo, Cout) dense: x's dtype, or int32 when
// epilogue = 0. kh is implied by K = kh*kw*Cin/groups (the rows of w8).
// groups divides Cin and Cout.
extern "C" int icaf_conv_int8(const void* x, long long sb, long long sc,
                              long long sh, long long sw, const void* w8,
                              const void* s_in, const void* s_w,
                              const void* gamma, const void* beta,
                              const void* mean, const void* var, float eps,
                              void* out, int B, int Cin, int H, int W,
                              int Cout, int kh, int kw, int stride_h,
                              int stride_w, int pad_h, int pad_w, int Ho,
                              int Wo, int is_bf16, int act, int epilogue,
                              int groups, void* stream) {
  if (groups < 1 || Cin % groups || Cout % groups) return cudaErrorInvalidValue;
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
  p.kw = kw;
  p.stride_h = stride_h;
  p.stride_w = stride_w;
  p.pad_h = pad_h;
  p.pad_w = pad_w;
  p.Ho = Ho;
  p.Wo = Wo;
  p.M = B * Ho * Wo;
  p.Cin_g = Cin / groups;
  p.Cout_g = Cout / groups;
  p.n_tiles_g = (p.Cout_g + kBN - 1) / kBN;
  p.K = kh * kw * p.Cin_g;
  p.act = act;
  if (p.M == 0 || Cout == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(p, epilogue, st)
                 : launch<float>(p, epilogue, st);
}

// The "tma" path (see the note at the top): the arguments of
// icaf_conv_int8 up to out, then ws ((splits, B, Ho, Wo, Cout) int32, null
// unless splits > 1) and counters ((tiles * groups,) int32, zero), the
// shape, and kernels/conv_int8.py: plan()'s tile (th, tw), groups, splits,
// slice_units, chunks, b_stages and its shared-memory layout (layout():
// the bytes of one window copy, the offsets of the copies, of mult/add and
// of the barriers, and the total), which this entry only checks for
// overlaps and bounds. x: channels innermost (sc == 1), 16-byte aligned,
// pixel strides multiples of 16 bytes; Cin % 16 == 0, Cout % 8 == 0;
// stride 1 or 2 in both dimensions.
extern "C" int icaf_conv_int8_tma(
    const void* x, long long sb, long long sc, long long sh, long long sw,
    const void* w8, const void* s_in, const void* s_w, const void* gamma,
    const void* beta, const void* mean, const void* var, float eps,
    void* out, void* ws, void* counters, int B, int Cin, int H, int W,
    int Cout, int kh, int kw, int stride_h, int stride_w, int pad_h,
    int pad_w, int Ho, int Wo, int is_bf16, int act, int epilogue, int th,
    int tw, int groups, int splits, int slice_units, int chunks,
    int b_stages, int copy_bytes, int off_q, int off_ep, int off_bar,
    int smem, void* stream) {
  using namespace tma;
  if (B == 0 || Cout == 0) return cudaSuccess;
  const int esz = is_bf16 ? 2 : 4;
  if (sc != 1 || Cin % 16 || Cout % 8 || (sb * esz) % 16 || (sh * esz) % 16 ||
      (sw * esz) % 16 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w8) % 16 || th * tw > kSlots ||
      ((kh - 1) / stride_h > 0 && tw % 8) || stride_h != stride_w ||
      (stride_h != 1 && stride_h != 2) || b_stages < 1 ||
      b_stages > kBStagesMax ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  tma::Params p;
  p.x = x;
  p.sb = sb;
  p.sh_ = sh;
  p.sw_ = sw;
  p.s_in = static_cast<const float*>(s_in);
  p.s_w = static_cast<const float*>(s_w);
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.mean = static_cast<const float*>(mean);
  p.var = static_cast<const float*>(var);
  p.eps = eps;
  p.out = out;
  p.ws = static_cast<int*>(ws);
  p.counters = static_cast<int*>(counters);
  p.out_elems = static_cast<long long>(B) * Ho * Wo * Cout;
  p.Cin = Cin;
  p.Cout = Cout;
  p.kh = kh;
  p.kw = kw;
  p.sh = stride_h;
  p.ph = pad_h;
  p.pw = pad_w;
  p.Ho = Ho;
  p.Wo = Wo;
  p.H = H;
  p.W = W;
  p.th = th;
  p.tw = tw;
  p.hh = (th - 1) * stride_h + kh;
  p.hw = (tw - 1) * stride_w + kw;
  p.tiles_w = (Wo + tw - 1) / tw;
  p.tiles_h = (Ho + th - 1) / th;
  p.groups = groups;
  p.n_tiles = (Cout + kN - 1) / kN;
  p.npg = (p.n_tiles + groups - 1) / groups;
  p.splits = splits;
  p.slice_units = slice_units;
  p.b_stages = b_stages;
  p.act = act;
  // kw * sh copies of the window, (kx, py): rows j * tw + c hold window
  // pixel (j * sh + py, c * sw + kx); a tap (ky, kx) reads copy
  // (kx, ky % sh) from row (ky / sh) * tw on, 64 rows a warpgroup. A copy
  // must hold the rows the kernel writes and the deepest tap reads.
  const int lift = (kh - 1) / stride_h;   // the largest ky / sh
  const long long rows = (th + lift) * tw > kSlots + lift * tw
                             ? (th + lift) * tw : kSlots + lift * tw;
  p.copy_bytes = copy_bytes;
  p.chunk_bytes = kw * stride_h * copy_bytes;
  p.off_q = off_q;
  p.off_ep = off_ep;
  p.off_bar = off_bar;
  if (copy_bytes % (8 * kQ) || copy_bytes < rows * kQ || off_q % 1024 ||
      off_q < b_stages * kBStage ||
      off_ep < off_q + static_cast<long long>(chunks) * p.chunk_bytes ||
      off_ep % 16 || off_bar < off_ep + p.npg * kN * 8 || off_bar % 8 ||
      1024LL + off_bar + 128 > smem || smem > kSmemMax ||
      (splits - 1) * slice_units * 32 >= Cin ||
      (slice_units * 32 + kQ - 1) / kQ > chunks)
    return cudaErrorInvalidValue;
  const int grid = B * p.tiles_h * p.tiles_w * groups * splits;

  CUtensorMap wmap;   // w8 as (Cin, kh * kw, Cout), 128 x 128-byte boxes
  const cuuint64_t wdims[3] = {(cuuint64_t)Cin, (cuuint64_t)(kh * kw),
                               (cuuint64_t)Cout};
  const cuuint64_t wstrides[2] = {(cuuint64_t)Cin, (cuuint64_t)kh * kw * Cin};
  const cuuint32_t wbox[3] = {kQ, 1, kN};
  const cudaError_t err =
      hopper::encode_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w8, 3, wdims,
                         wstrides, wbox);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_epi<__nv_bfloat16>(wmap, p, grid, smem, epilogue, st)
                 : launch_epi<float>(wmap, p, grid, smem, epilogue, st);
}
