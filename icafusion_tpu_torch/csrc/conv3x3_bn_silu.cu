// Fused 3x3 convolution + BatchNorm affine + SiLU at 64 -> 64 channels,
// stride 1, zero padding 1, bf16 or fp32 in and out, NHWC (PyTorch's
// channels_last: the serving, evaluation and training paths' activations)
// or NCHW (what an ordinary (B, 3, H, W) tensor gives: a torch.export
// program, cli.export --validate, Grad-CAM, ensembles and hub models called
// on such tensors).
//
// Replaces the Pallas TPU kernel icafusion_tpu/kernels/packed_conv.py:
// packed_conv3x3_silu (body _kernel, weights packed by pack_weights). It
// computes
//   out[b, co, h, w] = SiLU(scale[co] * sum_{ci, kh, kw}
//                           x[b, ci, h + kh - 1, w + kw - 1] w[co, ci, kh, kw]
//                           + bias[co])
// with the eval-mode BatchNorm folded into (scale, bias) by the caller, for
// any B, H, W >= 1. The TPU kernel packs two pixels into one 128-lane group
// to fill its 128-wide matrix unit; Hopper has no 128-lane constraint, so
// that packing is not carried over. Every path is an implicit GEMM:
// M = B*H*W pixels, N = 64 output channels, K = 576 = 9 taps x 64 channels.
//
// What bounds it on the H100: at the serving shape x = (4, 64, 160, 160)
// bf16 the work is 7.55 GFLOP (7.6 us at 989 TFLOP/s) against 26.2 MB of
// activations in and out plus 74 KB of weights (7.8 us at 3.35 TB/s): bytes
// and operations bound it about equally, so the loads, the tensor cores and
// the stores have to overlap.
//
// Routes (kernels/packed_conv.py: route; route_of below mirrors it, and the
// C entry refuses a route that differs):
//   nhwc      channels_last: TMA loads each tile's halo pixel-major;
//   nchw_tma  NCHW whose rows are a multiple of 16 bytes (W % 8 == 0 in
//             bf16, W % 4 == 0 in fp32), as a TMA tensor map's strides must
//             be: TMA loads a channel-major box. Its start in the innermost
//             dimension (W) must be 16-byte aligned too (at w0 - 1 the
//             load traps: an illegal instruction), so the box starts 16
//             bytes left of the tile and the halo lies inside it;
//   nchw_ld   every other NCHW map: the threads load the halo themselves
//             and mask the edge.
// Each dtype has one kernel body, a template on the route: the weight
// staging, the products and the epilogue's arithmetic are shared; only the
// halo's load and the stores differ. One launch a call, no pre-pass.
//
// bf16 (conv3x3_bf16_{nhwc,nchw_tma,nchw_ld}_kernel):
//   - persistent and balanced: one block per SM, whose two warpgroups are
//     independent workers, each with its own halo ring and barriers, so
//     that one's epilogue overlaps the other's products. The workers walk
//     the 4 x 16-pixel output tiles with a static stride (1600 tiles at
//     the serving shape over 264 workers); worker w = warpgroup * blocks +
//     block, so a last, partial round falls on distinct SMs;
//   - nhwc: TMA halo loads, a 4-D tensor map over x (C, W, H, B), box
//     (64, 18, 6, 1), 128-byte swizzle. Each load starts at
//     (0, w0 - 1, h0 - 1, b); the hardware zero-fills what lies outside x,
//     which is the conv's zero pad and the ragged edge, so nothing is
//     masked on the load side. A ring of 4 halo buffers per warpgroup with
//     mbarriers keeps its next three tiles in flight while a tile computes;
//   - wgmma m64n64k16, bf16 in, fp32 accumulation, A from registers: the
//     warpgroup's 64 pixels are the tile, one 16-pixel row a warp. A is the
//     halo window at tap (kh, kw), 16 pixels x 16 channels per warp, loaded
//     by ldmatrix (a shifted window is no valid wgmma descriptor, but
//     ldmatrix takes any 16-byte row address). Under the 128-byte swizzle
//     chunk c of halo pixel p sits at p*128 + ((c ^ (p & 7)) * 16), which
//     makes those reads free of bank conflicts for every shift. 36 k-steps
//     per tile (9 taps x 4 channel groups), double-buffered A fragments;
//   - B, the 576 x 64 weights, stays in shared memory for the whole kernel
//     as 9 K-major 128-byte-swizzled 64 x 64 tiles (the wgmma descriptor's
//     layout); each block writes it once from w's (co, ci, kh, kw) order;
//   - nchw: ldmatrix needs each pixel's 8 channels at one 16-byte address,
//     which a channel-major box shifted by a pixel never gives. So each
//     warpgroup first writes the tile's halo pixel-major, in the nhwc
//     route's swizzled layout, into a halo buffer of its own (one pass a
//     tile: a thread's 8 channels of a pixel, one 16-byte store), and the
//     products run as above. nchw_tma: TMA loads the channel-major box (32
//     columns w0 - 8 .. w0 + 23, 6 rows, 64 channels: 24 KB, no swizzle) at
//     (w0 - 8, h0 - 1, 0, b) with the zero fill, into 2 slots a warpgroup;
//     a slot is refilled, two tiles ahead, as soon as the halo is written
//     from it. nchw_ld: the warpgroup reads x itself, 2 bytes a value, zero
//     outside x, all 56 of a thread's loads issued before its stores;
//   - epilogue from registers: scale * acc + bias and SiLU in fp32, one
//     rounding to bf16. nhwc: a quad shuffle so that each thread holds 16
//     consecutive channels of a pixel, and 16-byte stores (a warp writes
//     its 16 pixels' 2 KB contiguously). nchw: lanes qg and qg ^ 1 swap so
//     that each holds two neighbouring pixels of a channel, one 4-byte
//     store where W is even (two 2-byte ones where it is odd: the pair
//     then may start at an odd element); the 8 lanes of a channel write
//     its row's 32 bytes.
//   Shared memory: 185.6 KB (nhwc), 197.5 KB (nchw_tma), 101.5 KB
//   (nchw_ld); one block per SM.
//
// fp32 (conv3x3_tf32_{nhwc,nchw_tma,nchw_ld}_kernel), on tensor cores at
// fp32 accuracy through the 3xTF32 split: each operand x = big + small,
// big = tf32(x), small = tf32(x - big), and a b taken as small_a big_b +
// big_a small_b + big_a big_b in fp32 accumulators. Bound: operations at
// 495 / 3 = 165 TFLOP/s, 0.0458 ms at (4, 64, 160, 160) against bytes'
// 0.016:
//   - B, the weights, must lie in shared memory with both halves: 295 KB
//     for all 64 output channels, more than a block may have. So a block
//     owns 32 output channels (147.5 KB of split weights, staged once from
//     w's order), blocks 2i and 2i + 1 take the two halves of the same
//     tiles, and the second read of each halo comes from L2;
//   - persistent blocks walk 8 x 16-pixel tiles through a ring of 3 half
//     halos (32 channels of a 10 x 18-pixel window), two ahead. nhwc:
//     thread 0 loads each by TMA (one 128-byte swizzle box, 22.5 KB) with
//     full/empty mbarriers; the zero fill is the conv's padding and the
//     ragged edge. No producer warp: a ninth warp caps the threads at 168
//     registers, and the accumulators spill. nchw_tma: a channel-major box,
//     32 channels x 10 rows x 28 columns (w0 - 4 .. w0 + 23: a 16-byte
//     aligned start), 35 KB, no swizzle, in a ring of 2 (3 do not fit):
//     thread 0 refills a slot with the item after next once every warp has
//     read it. nchw_ld: the same boxes, filled by every thread's 4-byte
//     cp.async copies (zero outside x), one group an item, with a block
//     barrier after each item's wait and before each refill;
//   - wgmma m64n32k8 .tf32, A from registers: warpgroup wg computes rows
//     4 wg .. 4 wg + 3 of the tile, a warp 16 pixels of a row. A lane
//     takes 4 channels of a pixel of the shifted window: nhwc channels
//     4t .. 4t + 3 of a 16-channel unit as one 16-byte chunk; nchw
//     channels t, t + 4, t + 8, t + 12 as four scalars, so that a warp's
//     reads fall in 32 distinct banks (a channel lies 280 words, 24 banks,
//     from the next); the weights are staged in the matching k order. It
//     splits them in registers (cvt.rna and a subtraction each) and feeds
//     two k8 steps, 3 products each, from double-buffered fragments. The
//     tensor cores' fp32 accumulation truncates, so each tap starts fresh
//     accumulators whose sums the CUDA cores add to the pixel's total,
//     rounding to nearest; one for each of the three products, so that
//     three chains of these small wgmmas run at once;
//   - epilogue from registers: scale * acc + bias and the exact fp32 SiLU.
//     nhwc: 8-byte stores; nchw: 4-byte stores, the 8 lanes of a channel
//     covering 8 neighbouring pixels (32 bytes).
//   Shared memory: 214.3 KB (nhwc), 215.3 KB (nchw); one block per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kC = 64;                     // channels in and out
constexpr int kTaps = 9;

// kernels/packed_conv.py: ROUTES
enum Route : int { kNhwc = 0, kNchwTma = 1, kNchwLd = 2 };

// kernels/packed_conv.py: route. The rows of an NCHW map lie W elements
// apart, and a TMA tensor map's strides must be multiples of 16 bytes.
int route_of(int W, int is_bf16, int nhwc) {
  if (nhwc) return kNhwc;
  return W % (is_bf16 ? 8 : 4) == 0 ? kNchwTma : kNchwLd;
}

__device__ __forceinline__ float silu(float y) { return y / (1.f + expf(-y)); }

// ===========================================================================
// bf16: TMA (or the threads' loads) + wgmma, persistent
// ===========================================================================

namespace bf16 {

constexpr int kTH = 4, kTW = 16;                   // output tile (pixels)
constexpr int kHH = kTH + 2, kHW = kTW + 2;        // with its halo: 6 x 18
constexpr int kHaloBytes = kHH * kHW * kC * 2;     // 13824
constexpr int kHaloSlot = 14 * 1024;               // swizzle atoms are 1 KB
// nchw_tma: TMA's start in the innermost dimension must be 16-byte
// aligned, so the box starts 8 columns left of the tile (halo column c is
// box column c + 7) and spans 32 (w0 - 8 .. w0 + 23)
constexpr int kBoxW = 32, kBoxCol0 = 7;
constexpr int kBoxBytes = kC * kHH * kBoxW * 2;    // 24576
constexpr int kTapBytes = kC * kC * 2;             // one 64 x 64 weight tile
constexpr int kWBytes = kTaps * kTapBytes;         // 73728
constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;

// A warpgroup's buffers: nhwc a ring of 4 halos (TMA writes them swizzled);
// nchw_tma 2 channel-major boxes and the halo written from them (a box is
// free once written out, so two tiles are still in flight); nchw_ld the
// halo alone.
__host__ __device__ constexpr int stages(int r) {
  return r == kNhwc ? 4 : r == kNchwTma ? 2 : 0;
}
__host__ __device__ constexpr int stage_bytes(int r) {
  return r == kNhwc ? kHaloSlot : kBoxBytes;
}
__host__ __device__ constexpr int halo_offset(int r) {   // nchw
  return stages(r) * stage_bytes(r);
}
__host__ __device__ constexpr int wg_bytes(int r) {
  return halo_offset(r) + (r == kNhwc ? 0 : kHaloSlot);
}
__host__ __device__ constexpr size_t smem_bytes(int r) {
  return 1024 /* alignment slack */ + kWBytes + kWarpgroups * wg_bytes(r) +
         2 * kC * 4 + kWarpgroups * stages(r) * 8;
}
static_assert(kHaloBytes <= kHaloSlot, "halo fits a slot");
static_assert(smem_bytes(kNhwc) <= 232448 && smem_bytes(kNchwTma) <= 232448,
              "shared memory");

struct Geometry {
  int H, W, tiles_w, tiles_h, tiles;
};

__device__ __forceinline__ void tile_origin(int t, const Geometry& g, int* b,
                                            int* h0, int* w0) {
  *w0 = (t % g.tiles_w) * kTW;
  t /= g.tiles_w;
  *h0 = (t % g.tiles_h) * kTH;
  *b = t / g.tiles_h;
}

// Tile t's halo by TMA into dst: nhwc the swizzled pixel-major halo, box
// (64, 18, 6, 1) over (C, W, H, B) from one pixel up and left of the tile;
// nchw_tma the channel-major box (32, 6, 64, 1) over (W, H, C, B) from one
// row up and 8 columns left.
template <int R>
__device__ __forceinline__ void load_halo(const CUtensorMap* xmap,
                                          uint32_t dst, uint32_t bar, int t,
                                          const Geometry& g) {
  int b, h0, w0;
  tile_origin(t, g, &b, &h0, &w0);
  if constexpr (R == kNhwc) {
    mbar_expect_tx(bar, kHaloBytes);
    tma_load_4d(dst, xmap, bar, 0, w0 - 1, h0 - 1, b);
  } else {
    mbar_expect_tx(bar, kBoxBytes);
    tma_load_4d(dst, xmap, bar, w0 - 1 - kBoxCol0, h0 - 1, 0, b);
  }
}

// nchw: the tile's 6 x 18 halo pixels written pixel-major into `halo` in
// the layout TMA's 128-byte swizzle gives the nhwc route (chunk c of pixel
// p at p * 128 + ((c ^ (p & 7)) << 4)), from value(ci, r, col), the raw
// bf16 of channel ci at halo row r and column col. A unit is chunk c of a
// pixel, 8 channels, one 16-byte store; a warp's lanes take 32 neighbouring
// pixels. Every load is issued before the first store.
constexpr int kFillUnits = kHH * kHW * 8;                     // 864
constexpr int kFillRounds = (kFillUnits + 127) / 128;         // 7
template <typename Value>
__device__ __forceinline__ void fill_halo(unsigned char* halo, int i,
                                          Value value) {   // i: thread of 128
  uint32_t v[kFillRounds][4];
#pragma unroll
  for (int k = 0; k < kFillRounds; ++k) {
    const int u = i + 128 * k, p = u % (kHH * kHW), c = u / (kHH * kHW);
    const int r = p / kHW, col = p % kHW;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[k][e] = u < kFillUnits
                    ? (uint32_t)value(8 * c + 2 * e, r, col) |
                          ((uint32_t)value(8 * c + 2 * e + 1, r, col) << 16)
                    : 0u;
  }
#pragma unroll
  for (int k = 0; k < kFillRounds; ++k) {
    const int u = i + 128 * k, p = u % (kHH * kHW), c = u / (kHH * kHW);
    if (u < kFillUnits)
      *reinterpret_cast<uint4*>(halo + p * 128 + ((c ^ (p & 7)) << 4)) =
          make_uint4(v[k][0], v[k][1], v[k][2], v[k][3]);
  }
}

// The weights w (co, ci, kh, kw) into shared memory as 9 tap tiles
// [co][ci] of 128-byte rows, 16-byte chunk c of row co at (c ^ (co & 7)).
// A unit (co, 8 input channels) reads its 72 contiguous values (144 bytes)
// and writes one 16-byte chunk per tap.
__device__ __forceinline__ void stage_weights_sw128(const uint4* __restrict__ w,
                                                    unsigned char* ws) {
  for (int u = threadIdx.x; u < kC * 8; u += kThreads) {
    const int co = u >> 3, c = u & 7;
    uint32_t v[36];
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const uint4 x = w[u * 9 + i];
      v[4 * i] = x.x;
      v[4 * i + 1] = x.y;
      v[4 * i + 2] = x.z;
      v[4 * i + 3] = x.w;
    }
    auto elem = [&](int e) { return (v[e >> 1] >> ((e & 1) * 16)) & 0xffffu; };
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      uint32_t o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)   // input channels c*8 + 2k, c*8 + 2k + 1
        o[k] = elem(2 * k * kTaps + tap) | (elem((2 * k + 1) * kTaps + tap) << 16);
      *reinterpret_cast<uint4*>(ws + tap * kTapBytes + co * 128 +
                                ((c ^ (co & 7)) << 4)) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

__device__ __forceinline__ float silu_fast(float y) {
  return __fdividef(y, 1.f + __expf(-y));   // -0 for y below about -88
}

// Two warpgroups per block, each an independent worker with its own
// buffers and barriers, so that one's epilogue overlaps the other's
// products. Worker w = warpgroup * blocks + block takes tiles w,
// w + workers, ..., so the tiles of a last, partial round land on distinct
// SMs. x is read through xmap (nhwc, nchw_tma) or directly (nchw_ld).
template <int R>
__device__ __forceinline__ void conv_bf16(const CUtensorMap* xmap,
                                          const unsigned short* __restrict__ x,
                                          const uint4* __restrict__ w,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ bias,
                                          __nv_bfloat16* __restrict__ out,
                                          const Geometry& g) {
  constexpr int S = stages(R);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* ws = smem_raw + (base - raw);
  float* s_scale = reinterpret_cast<float*>(
      ws + kWBytes + kWarpgroups * wg_bytes(R));
  float* s_bias = s_scale + kC;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, row = warp & 3;   // the warp's output row
  const bool leader = (tid & 127) == 0;
  unsigned char* region = ws + kWBytes + wg * wg_bytes(R);
  const uint32_t ring = base + kWBytes + wg * wg_bytes(R);
  const uint32_t bars = smem_u32(s_bias + kC) + wg * S * 8;
  const int workers = gridDim.x * kWarpgroups;
  const int first = wg * gridDim.x + blockIdx.x;

  if constexpr (S > 0) {
    if (leader) {
      tma_prefetch_map(xmap);
      for (int s = 0; s < S; ++s) mbar_init(bars + 8 * s, 1);
      mbar_init_fence();
      // the first tiles start loading: nhwc keeps slot j - 1 until tile j
      // starts, nchw_tma refills a slot as soon as it is written out
      for (int j = 0; j < (R == kNhwc ? S - 1 : S); ++j) {
        const int t = first + j * workers;
        if (t < g.tiles)
          load_halo<R>(xmap, ring + j * stage_bytes(R), bars + 8 * j, t, g);
      }
    }
  }
  stage_weights_sw128(w, ws);
  if (tid < kC) {
    s_scale[tid] = scale[tid];
    s_bias[tid] = bias[tid];
  }
  fence_proxy_async();   // the weights are read by wgmma (async proxy)
  __syncthreads();

  // ldmatrix: lane -> pixel m of the warp's 16 and 8-channel half of the
  // 16-channel group.
  const int m = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int khalf = lane >> 4;
  const int qg = lane >> 2, qt = lane & 3;   // accumulator row / column pair

  int j = 0;
  for (int t = first; t < g.tiles; t += workers, ++j) {
    // nchw: the warpgroup's halo; nhwc: ring slot s
    uint32_t buf = ring + halo_offset(R);
    if constexpr (S > 0) {
      const int s = j % S;
      if (R == kNhwc && leader) {   // refill the slot released last tile
        const int tn = t + (S - 1) * workers;
        const int sn = (j + S - 1) % S;
        if (tn < g.tiles)
          load_halo<R>(xmap, ring + sn * stage_bytes(R), bars + 8 * sn, tn, g);
      }
      mbar_wait(bars + 8 * s, (j / S) & 1);
      if constexpr (R == kNhwc) {
        buf = ring + s * kHaloSlot;
      } else {
        const unsigned short* box =
            reinterpret_cast<const unsigned short*>(region + s * kBoxBytes);
        fill_halo(region + halo_offset(R), tid & 127,
                  [&](int ci, int r, int col) {
                    return box[(ci * kHH + r) * kBoxW + kBoxCol0 + col];
                  });
        named_barrier(1 + wg, 128);   // slot s is read: refill it
        const int tn = t + S * workers;
        if (leader && tn < g.tiles)
          load_halo<R>(xmap, ring + s * kBoxBytes, bars + 8 * s, tn, g);
      }
    } else {
      int b, h0, w0;
      tile_origin(t, g, &b, &h0, &w0);
      const size_t plane = (size_t)g.H * g.W;
      const unsigned short* xb = x + (size_t)b * kC * plane;
      fill_halo(region + halo_offset(R), tid & 127,
                [&](int ci, int r, int col) -> unsigned short {
                  const int h = h0 - 1 + r, ww = w0 - 1 + col;
                  return h >= 0 && h < g.H && ww >= 0 && ww < g.W
                             ? xb[ci * plane + (size_t)h * g.W + ww]
                             : (unsigned short)0;   // bf16 +0
                });
    }
    if constexpr (R == kNchwLd) named_barrier(1 + wg, 128);   // halo written
    __syncwarp();   // ldmatrix and wgmma need the whole warp converged

    auto load_a = [&](int tap, uint32_t (&a)[4][4]) {
      const int p = (row + tap / 3) * kHW + m + tap % 3;
      const uint32_t rowp = buf + p * 128;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        ldmatrix_x4(a[q], rowp + (((2 * q + khalf) ^ (p & 7)) << 4));
    };
    float acc[32];
    uint32_t a[2][4][4];
    load_a(0, a[0]);
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wgmma_m64n64k16_rs(acc, a[tap & 1][q],
                           desc_sw128(base + tap * kTapBytes + q * 32),
                           (tap | q) != 0);
      wgmma_commit();
      if (tap + 1 < kTaps) {
        wgmma_wait<1>();          // tap - 1 is done with the other A set
        load_a(tap + 1, a[(tap + 1) & 1]);
      }
    }
    wgmma_wait<0>();
    // the warpgroup's four warps are done reading the halo
    named_barrier(1 + wg, 128);

    // Epilogue. acc[4j + 2h + e]: pixel qg + 8h, channel 8j + 2qt + e.
    int b, h0, w0;
    tile_origin(t, g, &b, &h0, &w0);
    const int h = h0 + row;
    if constexpr (R == kNhwc) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        uint32_t word[8];   // word[j]: channels 8j + 2qt, +1
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int co = 8 * jj + 2 * qt;
          word[jj] = pack_bf16(
              silu_fast(fmaf(acc[4 * jj + 2 * hf], s_scale[co], s_bias[co])),
              silu_fast(fmaf(acc[4 * jj + 2 * hf + 1], s_scale[co + 1],
                             s_bias[co + 1])));
        }
        // quad transpose: thread qt ends with channels 16 qt .. 16 qt + 15;
        // r[k][i] comes from lane qt ^ k and holds its word[2 qt + i]
        uint32_t r[4][2];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            r[k][i] = __shfl_xor_sync(
                0xffffffffu,
                pick4(word[i], word[2 + i], word[4 + i], word[6 + i], qt ^ k),
                k);
        const int wcol = w0 + qg + 8 * hf;
        if (h < g.H && wcol < g.W) {
          uint4* dst = reinterpret_cast<uint4*>(
              out + (((size_t)b * g.H + h) * g.W + wcol) * kC + 16 * qt);
#pragma unroll
          for (int i = 0; i < 2; ++i)   // channels 16 qt + 8 i .. + 7
            dst[i] = make_uint4(pick4(r[0][i], r[1][i], r[2][i], r[3][i], qt),
                                pick4(r[0][i], r[1][i], r[2][i], r[3][i], qt ^ 1),
                                pick4(r[0][i], r[1][i], r[2][i], r[3][i], qt ^ 2),
                                pick4(r[0][i], r[1][i], r[2][i], r[3][i], qt ^ 3));
        }
      }
    } else {
      // Lanes qg and qg ^ 1 (lane ^ 4) swap a value of each channel: the
      // even one then holds pixels qg, qg + 1, the odd one qg + 7, qg + 8.
      const bool odd = qg & 1;
      const int wcol = w0 + (odd ? qg + 7 : qg);
      const size_t plane = (size_t)g.H * g.W;
      __nv_bfloat16* dst =
          out + (size_t)b * kC * plane + (size_t)h * g.W + wcol;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = 8 * jj + 2 * qt + e;
          const float y0 =
              silu_fast(fmaf(acc[4 * jj + e], s_scale[co], s_bias[co]));
          const float y1 =
              silu_fast(fmaf(acc[4 * jj + 2 + e], s_scale[co], s_bias[co]));
          const float got = __shfl_xor_sync(0xffffffffu, odd ? y0 : y1, 4);
          const float lo = odd ? got : y0, hi = odd ? y1 : got;
          if (h >= g.H) continue;
          __nv_bfloat16* p = dst + co * plane;
          // W even (nchw_tma's always is): the pair starts at an even
          // element, 4-byte aligned, and both pixels lie in x or neither
          if (R == kNchwTma || (g.W & 1) == 0) {
            if (wcol < g.W) *reinterpret_cast<uint32_t*>(p) = pack_bf16(lo, hi);
          } else {
            if (wcol < g.W) p[0] = __float2bfloat16(lo);
            if (wcol + 1 < g.W) p[1] = __float2bfloat16(hi);
          }
        }
    }
  }
}

#define ICAF_BF16_KERNEL(NAME, ROUTE)                                        \
  __global__ void __launch_bounds__(kThreads, 1)                            \
      NAME(const __grid_constant__ CUtensorMap xmap,                         \
           const unsigned short* __restrict__ x, /* (B, 64, H, W) */        \
           const uint4* __restrict__ w,          /* (64, 64, 3, 3) */       \
           const float* __restrict__ scale, const float* __restrict__ bias, \
           __nv_bfloat16* __restrict__ out, Geometry g) {                    \
    conv_bf16<ROUTE>(&xmap, x, w, scale, bias, out, g);                      \
  }
ICAF_BF16_KERNEL(conv3x3_bf16_nhwc_kernel, kNhwc)
ICAF_BF16_KERNEL(conv3x3_bf16_nchw_tma_kernel, kNchwTma)
ICAF_BF16_KERNEL(conv3x3_bf16_nchw_ld_kernel, kNchwLd)
#undef ICAF_BF16_KERNEL

bool g_opt_in[3][kMaxDevices];   // [route][device]
int g_sms[kMaxDevices];

cudaError_t launch(int route, const void* x, const void* w,
                   const float* scale, const float* bias, void* out, int B,
                   int H, int W, cudaStream_t st) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  err = route == kNhwc
            ? opt_in_smem(conv3x3_bf16_nhwc_kernel, smem_bytes(kNhwc),
                          g_opt_in[kNhwc])
        : route == kNchwTma
            ? opt_in_smem(conv3x3_bf16_nchw_tma_kernel, smem_bytes(kNchwTma),
                          g_opt_in[kNchwTma])
            : opt_in_smem(conv3x3_bf16_nchw_ld_kernel, smem_bytes(kNchwLd),
                          g_opt_in[kNchwLd]);
  if (err != cudaSuccess) return err;
  if (g_sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
  }
  CUtensorMap xmap{};   // not read by nchw_ld
  if (route == kNhwc) {
    const cuuint64_t dims[4] = {(cuuint64_t)kC, (cuuint64_t)W, (cuuint64_t)H,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)kC * 2, (cuuint64_t)W * kC * 2,
                                   (cuuint64_t)H * W * kC * 2};
    const cuuint32_t box[4] = {kC, kHW, kHH, 1};
    err = encode_bf16_map(&xmap, x, 4, dims, strides, box);
  } else if (route == kNchwTma) {
    const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)kC,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)W * 2, (cuuint64_t)H * W * 2,
                                   (cuuint64_t)kC * H * W * 2};
    const cuuint32_t box[4] = {kBoxW, kHH, kC, 1};
    err = encode_bf16_map(&xmap, x, 4, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err != cudaSuccess) return err;
  Geometry g;
  g.H = H;
  g.W = W;
  g.tiles_w = (W + kTW - 1) / kTW;
  g.tiles_h = (H + kTH - 1) / kTH;
  g.tiles = B * g.tiles_w * g.tiles_h;
  const int blocks = (g.tiles + kWarpgroups - 1) / kWarpgroups;
  const int grid = blocks < g_sms[dev] ? blocks : g_sms[dev];
  auto xs = static_cast<const unsigned short*>(x);
  auto wv = static_cast<const uint4*>(w);
  auto o = static_cast<__nv_bfloat16*>(out);
  if (route == kNhwc)
    conv3x3_bf16_nhwc_kernel<<<grid, kThreads, smem_bytes(kNhwc), st>>>(
        xmap, xs, wv, scale, bias, o, g);
  else if (route == kNchwTma)
    conv3x3_bf16_nchw_tma_kernel<<<grid, kThreads, smem_bytes(kNchwTma), st>>>(
        xmap, xs, wv, scale, bias, o, g);
  else
    conv3x3_bf16_nchw_ld_kernel<<<grid, kThreads, smem_bytes(kNchwLd), st>>>(
        xmap, xs, wv, scale, bias, o, g);
  return cudaGetLastError();
}

}  // namespace bf16

// ===========================================================================
// fp32: TMA (or cp.async) + wgmma .tf32 with the 3xTF32 split, persistent
// ===========================================================================

namespace tf32 {

constexpr int kTH = 8, kTW = 16;                   // output tile (pixels)
constexpr int kHH = kTH + 2, kHW = kTW + 2;        // with its halo: 10 x 18
constexpr int kHalfC = 32;                         // channels a stage (128 B)
constexpr int kHaloBytes = kHH * kHW * kHalfC * 4; // 23040: nhwc half halo
// nchw: TMA's start in the innermost dimension must be 16-byte aligned, so
// the box starts 4 columns left of the tile (halo column c is box column
// c + 3) and spans 28, which also puts a channel 280 words (24 banks mod
// 32) from the next
constexpr int kBoxW = 28, kBoxCol0 = 3;
constexpr int kBoxBytes = kHalfC * kHH * kBoxW * 4;   // 35840
constexpr int kCo = 32;                            // output channels a block
constexpr int kWTile = kCo * 128;                  // a (tap, half) tile: 32 x 32
constexpr int kWBytes = kTaps * 2 * kWTile;        // 73728, each of big, small
// Two warpgroups and no producer warp: a ninth warp would put three warps
// on one SM sub-partition and cap every thread at 168 registers, and the
// kernel then spills its accumulators; thread 0 issues the loads.
constexpr int kThreads = 256;
constexpr int kUnits = 2 * kTaps * 2;              // (half, tap, 16 channels)
// The ring: nhwc 3 half halos, two ahead of the one read; nchw 2 boxes
// (3 do not fit), the next one's load refilling the slot just read
__host__ __device__ constexpr int stages(int r) { return r == kNhwc ? 3 : 2; }
__host__ __device__ constexpr int stage_bytes(int r) {
  return r == kNhwc ? 23 * 1024 /* swizzle atoms are 1 KB */ : kBoxBytes;
}
__host__ __device__ constexpr size_t smem_bytes(int r) {
  return 1024 /* alignment slack */ + 2 * kWBytes + stages(r) * stage_bytes(r) +
         2 * kCo * 4 + 2 * stages(r) * 8;
}
static_assert(kHaloBytes <= stage_bytes(kNhwc), "half a halo fits a stage");
static_assert(kBoxBytes % 128 == 0, "TMA boxes start 128-byte aligned");
static_assert(smem_bytes(kNhwc) <= 232448 && smem_bytes(kNchwTma) <= 232448,
              "shared memory");

struct Geometry {
  int H, W, tiles_w, tiles_h, tiles;
};

__device__ __forceinline__ void tile_origin(int t, const Geometry& g, int* b,
                                            int* h0, int* w0) {
  *w0 = (t % g.tiles_w) * kTW;
  t /= g.tiles_w;
  *h0 = (t % g.tiles_h) * kTH;
  *b = t / g.tiles_h;
}

// The pixel column of fragment row g (row g + 8 is 8 columns on): rows g
// and g + 1, which share a quarter-warp's 16-byte reads, lie 4 pixels
// apart, so that under the 128-byte swizzle their chunks fall in distinct
// halves of the 32 banks for every tap shift.
__device__ __forceinline__ int frag_col(int g) { return (g >> 1) + 4 * (g & 1); }

// K order. A unit is 16 channels of one half and one tap, two k8 steps.
// nhwc: lane t reads the 4 channels 4t .. 4t + 3 of its pixel as one
// 16-byte chunk, step 0 takes 4t and 4t + 1 as its k indices t and t + 4,
// step 1 4t + 2 and 4t + 3. nchw: lane t reads channels t, t + 4, t + 8,
// t + 12, step 0 takes the first two as k indices t and t + 4, step 1 the
// others: channel r of the unit lands at k r % 8 of step r / 8, so k
// position and channel are the same. The weights are stored in the same
// order: position k of k8 step kk (0..3 in a half: 2 units) holds this
// channel of the half.
template <int R>
__device__ __forceinline__ int weight_k(int ci_in_half) {
  if constexpr (R != kNhwc) return ci_in_half;
  const int grp = ci_in_half >> 4, r = ci_in_half & 15;
  return 8 * (2 * grp + ((r >> 1) & 1)) + (r >> 2) + 4 * (r & 1);
}

// The weights of output channels co0 .. co0 + 31, split: for each tap and
// channel half a K-major 32 x 32 tile [co][k] of 128-byte rows, chunk c of
// row co at (c ^ (co & 7)) (wgmma's 128-byte swizzle), the small halves
// kWBytes after the big ones. Read once a block in w's (co, ci, kh, kw)
// order, so there is no pre-pass launch.
template <int R>
__device__ __forceinline__ void stage_weights_tf32(const float* __restrict__ w,
                                                   int co0, unsigned char* ws) {
  const float* wc = w + (size_t)co0 * kC * kTaps;
#pragma unroll 4
  for (int e = threadIdx.x; e < kCo * kC * kTaps; e += kThreads) {
    const int co = e / (kC * kTaps), ci = (e / kTaps) % kC, tap = e % kTaps;
    const int k = weight_k<R>(ci & 31);
    const int off = (tap * 2 + (ci >> 5)) * kWTile + co * 128 +
                    (((k >> 2) ^ (co & 7)) << 4) + (k & 3) * 4;
    uint32_t big, small;
    split_tf32(wc[e], big, small);
    *reinterpret_cast<uint32_t*>(ws + off) = big;
    *reinterpret_cast<uint32_t*>(ws + kWBytes + off) = small;
  }
}

// Blocks 2i and 2i + 1 own output channels 0..31 and 32..63 and walk the
// same 8 x 16-pixel tiles (i, i + blocks / 2, ...), so the second read of a
// halo comes from L2. A stage holds item m, half m % 2 of the block's tile
// m / 2 (32 channels); two items ahead are in flight. Warpgroup wg
// computes tile rows 4 wg .. 4 wg + 3, one row of 16 pixels a warp. x is
// read through xmap (nhwc, nchw_tma) or directly (nchw_ld).
template <int R>
__device__ __forceinline__ void conv_tf32(const CUtensorMap* xmap,
                                          const float* __restrict__ x,
                                          const float* __restrict__ w,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ bias,
                                          float* __restrict__ out,
                                          const Geometry& g) {
  constexpr int S = stages(R), SB = stage_bytes(R);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* ws = smem_raw + (base - raw);
  const unsigned char* ring = ws + 2 * kWBytes;
  float* s_scale = reinterpret_cast<float*>(ws + 2 * kWBytes + S * SB);
  float* s_bias = s_scale + kCo;
  const uint32_t full = smem_u32(s_bias + kCo), empty = full + 8 * S;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int co0 = (blockIdx.x & 1) * kCo;
  const int walkers = gridDim.x >> 1, first = blockIdx.x >> 1;

  auto load_item = [&](int m) {   // nhwc, nchw_tma: thread 0
    const int t = first + (m >> 1) * walkers;
    if (t >= g.tiles) return;
    int b, h0, w0;
    tile_origin(t, g, &b, &h0, &w0);
    const int s = m % S;
    const uint32_t dst = base + 2 * kWBytes + s * SB;
    if constexpr (R == kNhwc) {
      mbar_expect_tx(full + 8 * s, kHaloBytes);
      tma_load_4d(dst, xmap, full + 8 * s, kHalfC * (m & 1), w0 - 1, h0 - 1,
                  b);
    } else {
      mbar_expect_tx(full + 8 * s, kBoxBytes);
      tma_load_4d(dst, xmap, full + 8 * s, w0 - 1 - kBoxCol0, h0 - 1,
                  kHalfC * (m & 1), b);
    }
  };
  // nchw_ld: every thread copies its share of item m's box (columns 0..17,
  // zero outside x), as one cp.async group (empty past the last tile)
  auto copy_item = [&](int m) {
    const int t = first + (m >> 1) * walkers;
    if (t < g.tiles) {
      int b, h0, w0;
      tile_origin(t, g, &b, &h0, &w0);
      const uint32_t dst = base + 2 * kWBytes + (m % S) * SB;
      const float* xc = x + ((size_t)b * kC + kHalfC * (m & 1)) * g.H * g.W;
      for (int e = tid; e < kHalfC * kHH * kHW; e += kThreads) {
        const int col = e % kHW, r = (e / kHW) % kHH, c = e / (kHW * kHH);
        const int h = h0 - 1 + r, ww = w0 - 1 + col;
        const bool in = h >= 0 && h < g.H && ww >= 0 && ww < g.W;
        cp_async_4(dst + ((c * kHH + r) * kBoxW + kBoxCol0 + col) * 4,
                   in ? xc + ((size_t)c * g.H + h) * g.W + ww : x, in);
      }
    }
    cp_async_commit();
  };
  if constexpr (R == kNchwLd) {
    copy_item(0);
    copy_item(1);
  } else if (tid == 0) {
    tma_prefetch_map(xmap);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kThreads / 32);   // one arrival per warp
    }
    mbar_init_fence();
    for (int m = 0; m < S; ++m) load_item(m);
  }

  stage_weights_tf32<R>(w, co0, ws);
  if (tid < kCo) {
    s_scale[tid] = scale[co0 + tid];
    s_bias[tid] = bias[co0 + tid];
  }
  fence_proxy_async();   // the weights are read by wgmma (async proxy)
  __syncthreads();

  const int row = 4 * (warp >> 2) + (warp & 3);   // the warp's tile row
  const int qg = lane >> 2, qt = lane & 3;
  const int col = frag_col(qg);

  // A of unit u (16 channels 16 (u & 1) .. of tap (u % 18) / 2 in half
  // u / 18): rows qg, qg + 8 (pixels col, col + 8 of the warp's row) at
  // 4 channels (weight_k), split into big and small fragments of its two
  // k8 steps
  auto load_unit = [&](int s, int u, uint32_t (&ab)[2][4],
                       uint32_t (&as)[2][4]) {
    const int tap = (u % 18) >> 1;
    const unsigned char* buf = ring + s * SB;
    float4 v[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if constexpr (R == kNhwc) {
        const int c = 4 * (u & 1) + qt;
        const int p = (row + tap / 3) * kHW + col + 8 * hf + tap % 3;
        v[hf] = *reinterpret_cast<const float4*>(buf + p * 128 +
                                                 ((c ^ (p & 7)) << 4));
      } else {   // channels qt, qt + 4, qt + 8, qt + 12 of the unit
        constexpr int kNext = 4 * kHH * kBoxW;   // 4 channels on
        const float* q = reinterpret_cast<const float*>(buf) +
                         ((16 * (u & 1) + qt) * kHH + row + tap / 3) * kBoxW +
                         kBoxCol0 + col + 8 * hf + tap % 3;
        v[hf] = make_float4(q[0], q[kNext], q[2 * kNext], q[3 * kNext]);
      }
    }
    split_tf32(v[0].x, ab[0][0], as[0][0]);
    split_tf32(v[1].x, ab[0][1], as[0][1]);
    split_tf32(v[0].y, ab[0][2], as[0][2]);
    split_tf32(v[1].y, ab[0][3], as[0][3]);
    split_tf32(v[0].z, ab[1][0], as[1][0]);
    split_tf32(v[1].z, ab[1][1], as[1][1]);
    split_tf32(v[0].w, ab[1][2], as[1][2]);
    split_tf32(v[1].w, ab[1][3], as[1][3]);
  };
  // Item m has arrived in its stage.
  auto acquire = [&](int m) {
    if constexpr (R == kNchwLd) {
      cp_async_wait<1>();   // all but the newest group (item m + 1)
      __syncthreads();      // every thread's copies of item m
    } else {
      mbar_wait(full + 8 * (m % S), (m / S) & 1);
      __syncwarp();   // wgmma needs the whole warp converged
    }
  };
  // This warp has read item m; item m + 2 goes into the stage of item
  // r = m + 2 - S. nhwc (S = 3): thread 0 refills the stage of item m - 1,
  // which every warp has (nearly always) released by now. nchw_tma
  // (S = 2): thread 0 waits for every warp to release item m. nchw_ld: once
  // every warp has read item m, every thread copies.
  auto release = [&](int m) {
    if constexpr (R == kNchwLd) {
      __syncthreads();
      copy_item(m + 2);
    } else {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * (m % S));
      const int r = m + 2 - S;
      if (tid == 0 && r >= 0) {
        mbar_wait(empty + 8 * (r % S), (r / S) & 1);
        load_item(m + 2);
      }
    }
  };

  // The tensor cores' fp32 accumulation truncates at each product: over a
  // pixel's 216 products that biases it by about 4e-5 of its size. So each
  // tap's products start fresh accumulators, whose sums the CUDA cores add
  // to `total`, rounding to nearest. Its three products go to three
  // accumulators (small_a big_b, big_a small_b, big_a big_b): a chain of
  // m64n32k8 products, each too small to hide its latency, runs at a
  // fraction of the rate, and three chains (two taps' sets in turn) keep
  // the tensor cores fed.
  int j = 0;   // tiles done: stages 2j and 2j + 1 are this tile's halves
  for (int t = first; t < g.tiles; t += walkers, ++j) {
    float acc[2][3][16], total[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) total[i] = 0.f;
    auto add_tap = [&](int set) {   // small sums first
#pragma unroll
      for (int i = 0; i < 16; ++i)
        total[i] += (acc[set][0][i] + acc[set][1][i]) + acc[set][2][i];
    };
    uint32_t ab[2][2][4], as[2][2][4];   // [A buffer][k8 step][fragment]
    int s = (2 * j) % S;
    acquire(2 * j);
    load_unit(s, 0, ab[0], as[0]);
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {   // unit u: half u / 18, tap (u % 18) / 2
      const int tap = (u % 18) >> 1, hh = u / 18, set = (u >> 1) & 1;
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        const uint32_t wb = base + (tap * 2 + hh) * kWTile +
                            (2 * (u & 1) + st) * 32;
        const int sd = (u & 1) | st;   // 0: a tap's sums start afresh
        wgmma_m64n32k8_tf32_rs(acc[set][0], as[u & 1][st], desc_sw128(wb), sd);
        wgmma_m64n32k8_tf32_rs(acc[set][1], ab[u & 1][st],
                               desc_sw128(wb + kWBytes), sd);
        wgmma_m64n32k8_tf32_rs(acc[set][2], ab[u & 1][st], desc_sw128(wb), sd);
      }
      wgmma_commit();
      if (u > 0) {
        wgmma_wait<1>();   // unit u - 1 is done with its A buffer
        if ((u & 1) == 0) add_tap(set ^ 1);   // ... and ended its tap
      }
      if (u + 1 < kUnits) {
        if (u + 1 == kUnits / 2) {   // the first half is read: the second
          release(2 * j);
          s = (2 * j + 1) % S;
          acquire(2 * j + 1);
        }
        load_unit(s, u + 1, ab[(u + 1) & 1], as[(u + 1) & 1]);
      }
    }
    release(2 * j + 1);
    wgmma_wait<0>();
    add_tap(((kUnits - 1) >> 1) & 1);

    // Epilogue. total[4jj + 2hf + e]: pixel col + 8 hf, channel
    // co0 + 8 jj + 2 qt + e.
    int b, h0, w0;
    tile_origin(t, g, &b, &h0, &w0);
    const int h = h0 + row;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int wcol = w0 + col + 8 * hf;
      if (h >= g.H || wcol >= g.W) continue;
      if constexpr (R == kNhwc) {   // 8-byte pairs
        float* dst = out + (((size_t)b * g.H + h) * g.W + wcol) * kC + co0;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int c = 8 * jj + 2 * qt;
          *reinterpret_cast<float2*>(dst + c) = make_float2(
              silu(fmaf(total[4 * jj + 2 * hf], s_scale[c], s_bias[c])),
              silu(fmaf(total[4 * jj + 2 * hf + 1], s_scale[c + 1],
                        s_bias[c + 1])));
        }
      } else {
        const size_t plane = (size_t)g.H * g.W;
        float* dst = out + ((size_t)b * kC + co0) * plane +
                     (size_t)h * g.W + wcol;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * jj + 2 * qt + e;
            dst[c * plane] =
                silu(fmaf(total[4 * jj + 2 * hf + e], s_scale[c], s_bias[c]));
          }
      }
    }
  }
}

#define ICAF_TF32_KERNEL(NAME, ROUTE)                                        \
  __global__ void __launch_bounds__(kThreads, 1)                            \
      NAME(const __grid_constant__ CUtensorMap xmap,                         \
           const float* __restrict__ x,      /* (B, 64, H, W) */            \
           const float* __restrict__ w,      /* (64, 64, 3, 3) */           \
           const float* __restrict__ scale, const float* __restrict__ bias, \
           float* __restrict__ out, Geometry g) {                            \
    conv_tf32<ROUTE>(&xmap, x, w, scale, bias, out, g);                      \
  }
ICAF_TF32_KERNEL(conv3x3_tf32_nhwc_kernel, kNhwc)
ICAF_TF32_KERNEL(conv3x3_tf32_nchw_tma_kernel, kNchwTma)
ICAF_TF32_KERNEL(conv3x3_tf32_nchw_ld_kernel, kNchwLd)
#undef ICAF_TF32_KERNEL

bool g_opt_in[3][kMaxDevices];   // [route][device]
int g_sms[kMaxDevices];

cudaError_t launch(int route, const void* x, const void* w,
                   const float* scale, const float* bias, void* out, int B,
                   int H, int W, cudaStream_t st) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  err = route == kNhwc
            ? opt_in_smem(conv3x3_tf32_nhwc_kernel, smem_bytes(kNhwc),
                          g_opt_in[kNhwc])
        : route == kNchwTma
            ? opt_in_smem(conv3x3_tf32_nchw_tma_kernel, smem_bytes(kNchwTma),
                          g_opt_in[kNchwTma])
            : opt_in_smem(conv3x3_tf32_nchw_ld_kernel, smem_bytes(kNchwLd),
                          g_opt_in[kNchwLd]);
  if (err != cudaSuccess) return err;
  if (g_sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
  }
  CUtensorMap xmap{};   // not read by nchw_ld
  if (route == kNhwc) {
    const cuuint64_t dims[4] = {(cuuint64_t)kC, (cuuint64_t)W, (cuuint64_t)H,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)kC * 4, (cuuint64_t)W * kC * 4,
                                   (cuuint64_t)H * W * kC * 4};
    const cuuint32_t box[4] = {kHalfC, kHW, kHH, 1};
    err = encode_f32_map(&xmap, x, 4, dims, strides, box);
  } else if (route == kNchwTma) {
    const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)kC,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)W * 4, (cuuint64_t)H * W * 4,
                                   (cuuint64_t)kC * H * W * 4};
    const cuuint32_t box[4] = {kBoxW, kHH, kHalfC, 1};
    err = encode_f32_map(&xmap, x, 4, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err != cudaSuccess) return err;
  Geometry g;
  g.H = H;
  g.W = W;
  g.tiles_w = (W + kTW - 1) / kTW;
  g.tiles_h = (H + kTH - 1) / kTH;
  g.tiles = B * g.tiles_w * g.tiles_h;
  const int walkers = g.tiles < g_sms[dev] / 2 ? g.tiles : g_sms[dev] / 2;
  auto xs = static_cast<const float*>(x);
  auto wv = static_cast<const float*>(w);
  auto o = static_cast<float*>(out);
  if (route == kNhwc)
    conv3x3_tf32_nhwc_kernel<<<2 * walkers, kThreads, smem_bytes(kNhwc), st>>>(
        xmap, xs, wv, scale, bias, o, g);
  else if (route == kNchwTma)
    conv3x3_tf32_nchw_tma_kernel<<<2 * walkers, kThreads,
                                   smem_bytes(kNchwTma), st>>>(
        xmap, xs, wv, scale, bias, o, g);
  else
    conv3x3_tf32_nchw_ld_kernel<<<2 * walkers, kThreads, smem_bytes(kNchwLd),
                                  st>>>(xmap, xs, wv, scale, bias, o, g);
  return cudaGetLastError();
}

}  // namespace tf32

}  // namespace

// x, out: (B, 64, H, W), bf16 (is_bf16) or fp32, both dense in NCHW or both
// in NHWC (channels_last, nhwc = 1), x 16-byte aligned; w: (64, 64, 3, 3)
// in x's dtype, 16-byte aligned; scale, bias: (64,) fp32; route:
// kernels/packed_conv.py's route of x (a Route), refused with
// cudaErrorInvalidValue where route_of gives another.
extern "C" int icaf_conv3x3_bn_silu(const void* x, const void* w,
                                    const void* scale, const void* bias,
                                    void* out, int B, int H, int W,
                                    int is_bf16, int nhwc, int route,
                                    void* stream) {
  if (route != route_of(W, is_bf16, nhwc)) return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  auto s = static_cast<const float*>(scale);
  auto b = static_cast<const float*>(bias);
  return is_bf16 ? bf16::launch(route, x, w, s, b, out, B, H, W, st)
                 : tf32::launch(route, x, w, s, b, out, B, H, W, st);
}
