// Fused 3x3 convolution + BatchNorm affine + SiLU at 64 -> 64 channels,
// stride 1, zero padding 1, bf16 or fp32 in and out, NCHW or NHWC
// (PyTorch's channels_last, the layout the serving path's activations have).
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
// bf16 NHWC, the serving path (conv3x3_bf16_nhwc_kernel), one launch:
//   - persistent and balanced: one block per SM, whose two warpgroups are
//     independent workers, each with its own halo ring and barriers, so
//     that one's epilogue overlaps the other's products. The workers walk
//     the 4 x 16-pixel output tiles with a static stride (1600 tiles at
//     the serving shape over 264 workers); worker w = warpgroup * blocks +
//     block, so a last, partial round falls on distinct SMs;
//   - TMA halo loads: a 4-D tensor map over x (C, W, H, B), box
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
//     layout); each block writes it once from w's (co, ci, kh, kw) order, so
//     there is no weight pre-pass launch;
//   - epilogue from registers: scale * acc + bias and SiLU in fp32, one
//     rounding to bf16, a quad shuffle so that each thread holds 16
//     consecutive channels of a pixel, and 16-byte stores (a warp writes its
//     16 pixels' 2 KB contiguously).
//   185.6 KB of shared memory, one block per SM.
//
// bf16 NCHW and fp32 (either layout) keep the first design, which is not on
// the serving path: a weight pre-pass launch rearranges w once per call;
// persistent blocks copy it to shared memory, stage one 16 x 16-pixel tile
// with its halo (masking the edge themselves), and multiply:
//   bf16  WMMA 16x16x16 tensor-core fragments, fp32 accumulation; each of 8
//         warps computes two 16-pixel rows by 64 channels.
//   fp32  CUDA-core FMAs, no TF32 (so it matches a plain version run with
//         cudnn.allow_tf32 off); each thread computes 8 pixels x 8 channels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "hopper.cuh"

namespace {

using namespace nvcuda;
using namespace hopper;

constexpr int kC = 64;                     // channels in and out
constexpr int kTaps = 9;

__device__ __forceinline__ float silu(float y) { return y / (1.f + expf(-y)); }

// ===========================================================================
// bf16 NHWC: TMA + wgmma, persistent
// ===========================================================================

namespace nhwc {

constexpr int kTH = 4, kTW = 16;                   // output tile (pixels)
constexpr int kHH = kTH + 2, kHW = kTW + 2;        // with its halo: 6 x 18
constexpr int kHaloBytes = kHH * kHW * kC * 2;     // 13824
constexpr int kStageBytes = 14 * 1024;             // swizzle atoms are 1 KB
constexpr int kStages = 4;                         // per warpgroup
constexpr int kTapBytes = kC * kC * 2;             // one 64 x 64 weight tile
constexpr int kWBytes = kTaps * kTapBytes;         // 73728
constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr size_t kSmem = 1024 /* alignment slack */ + kWBytes +
                         kWarpgroups * kStages * kStageBytes + 2 * kC * 4 +
                         kWarpgroups * kStages * 8;
static_assert(kHaloBytes <= kStageBytes, "halo fits a stage");
static_assert(kSmem <= 232448, "shared memory");

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

__device__ __forceinline__ void load_halo(const CUtensorMap* xmap,
                                          uint32_t dst, uint32_t bar, int t,
                                          const Geometry& g) {
  int b, h0, w0;
  tile_origin(t, g, &b, &h0, &w0);
  mbar_expect_tx(bar, kHaloBytes);
  tma_load_4d(dst, xmap, bar, 0, w0 - 1, h0 - 1, b);
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

// Two warpgroups per block, each an independent worker with its own ring of
// halo buffers and barriers, so that one's epilogue overlaps the other's
// products. Worker w = warpgroup * blocks + block takes tiles w,
// w + workers, ..., so the tiles of a last, partial round land on distinct
// SMs.
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_bf16_nhwc_kernel(const __grid_constant__ CUtensorMap xmap,
                         const uint4* __restrict__ w,     // (64, 64, 3, 3)
                         const float* __restrict__ scale,  // (64,)
                         const float* __restrict__ bias,   // (64,)
                         __nv_bfloat16* __restrict__ out,  // (B, H, W, 64)
                         Geometry g) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* ws = smem_raw + (base - raw);
  float* s_scale = reinterpret_cast<float*>(
      ws + kWBytes + kWarpgroups * kStages * kStageBytes);
  float* s_bias = s_scale + kC;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, row = warp & 3;   // the warp's output row
  const bool leader = (tid & 127) == 0;
  const uint32_t halo = base + kWBytes + wg * kStages * kStageBytes;
  const uint32_t bars = smem_u32(s_bias + kC) + wg * kStages * 8;
  const int workers = gridDim.x * kWarpgroups;
  const int first = wg * gridDim.x + blockIdx.x;

  if (leader) {
    tma_prefetch_map(&xmap);
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, 1);
    mbar_init_fence();
    for (int j = 0; j < kStages - 1; ++j) {   // the first tiles start loading
      const int t = first + j * workers;
      if (t < g.tiles) load_halo(&xmap, halo + j * kStageBytes, bars + 8 * j, t, g);
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
    const int s = j % kStages;
    if (leader) {   // refill the buffer the warpgroup released last tile
      const int tn = t + (kStages - 1) * workers;
      const int sn = (j + kStages - 1) % kStages;
      if (tn < g.tiles) load_halo(&xmap, halo + sn * kStageBytes, bars + 8 * sn, tn, g);
    }
    mbar_wait(bars + 8 * s, (j / kStages) & 1);
    __syncwarp();   // ldmatrix and wgmma need the whole warp converged

    const uint32_t buf = halo + s * kStageBytes;
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
    // the warpgroup's four warps are done reading buffer s
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");

    // Epilogue. acc[4j + 2h + e]: pixel qg + 8h, channel 8j + 2qt + e.
    int b, h0, w0;
    tile_origin(t, g, &b, &h0, &w0);
    const int h = h0 + row;
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
  }
}

bool g_opt_in[kMaxDevices];
int g_sms[kMaxDevices];

cudaError_t launch(const void* x, const void* w, const float* scale,
                   const float* bias, void* out, int B, int H, int W,
                   cudaStream_t st) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  err = opt_in_smem(conv3x3_bf16_nhwc_kernel, kSmem, g_opt_in);
  if (err != cudaSuccess) return err;
  if (g_sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
  }
  CUtensorMap xmap;
  const cuuint64_t dims[4] = {(cuuint64_t)kC, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)kC * 2, (cuuint64_t)W * kC * 2,
                                 (cuuint64_t)H * W * kC * 2};
  const cuuint32_t box[4] = {kC, kHW, kHH, 1};
  err = encode_bf16_map(&xmap, x, 4, dims, strides, box);
  if (err != cudaSuccess) return err;
  Geometry g;
  g.H = H;
  g.W = W;
  g.tiles_w = (W + kTW - 1) / kTW;
  g.tiles_h = (H + kTH - 1) / kTH;
  g.tiles = B * g.tiles_w * g.tiles_h;
  const int blocks = (g.tiles + kWarpgroups - 1) / kWarpgroups;
  const int grid = blocks < g_sms[dev] ? blocks : g_sms[dev];
  conv3x3_bf16_nhwc_kernel<<<grid, kThreads, kSmem, st>>>(
      xmap, static_cast<const uint4*>(w), scale, bias,
      static_cast<__nv_bfloat16*>(out), g);
  return cudaGetLastError();
}

}  // namespace nhwc

// ===========================================================================
// bf16 NCHW and fp32: the first design (weight pre-pass, WMMA / CUDA cores)
// ===========================================================================

constexpr int kThreads = 256;              // 8 warps
constexpr int kTH = 16, kTW = 16;          // output tile (pixels)
constexpr int kHH = kTH + 2, kHW = kTW + 2;  // the tile with its halo
constexpr int kHalo = kHH * kHW;

// bf16: input [ci / 16][kHH][kHW][ci % 16], weights
// [tap][ci / 16][co / 16][ci % 16][co % 16]
constexpr int kBfIn = kC * kHalo;
constexpr int kBfW = kTaps * kC * kC;
constexpr size_t kBfSmem = (size_t)(kBfIn + kBfW) * 2;
constexpr int kScrLd = 68;   // epilogue scratch row (floats), 16 per warp
static_assert(8 * 16 * kScrLd * 4 <= kBfIn * 2, "scratch fits in the tile");
// fp32: input [ci][kHH][kHW], weights [tap][ci][co]
constexpr size_t kF32Smem = (size_t)(kC * kHalo + kTaps * kC * kC) * 4;

// element (b, c, h, w) of a (B, 64, H, W) tensor, NCHW or NHWC in memory
template <bool NHWC>
__device__ __forceinline__ size_t at(int b, int c, int h, int w, int H,
                                     int W) {
  return NHWC ? (((size_t)b * H + h) * W + w) * kC + c
              : (((size_t)b * kC + c) * H + h) * W + w;
}

struct Tile {
  int b, h0, w0;
};

__device__ __forceinline__ Tile tile_of(int t, int tiles_h, int tiles_w) {
  Tile r;
  r.w0 = (t % tiles_w) * kTW;
  t /= tiles_w;
  r.h0 = (t % tiles_h) * kTH;
  r.b = t / tiles_h;
  return r;
}

// Staging loops issue kBatch independent global loads per thread before
// their shared-memory stores, so that the loads' latency overlaps.
constexpr int kBatch = 9;

// The weights' shared-memory layouts: index of w[co, ci, tap]
struct BfWeightIndex {   // [tap][ci / 16][co / 16][ci % 16][co % 16]
  __device__ int operator()(int co, int ci, int tap) const {
    return ((tap * 4 + (ci >> 4)) * 4 + (co >> 4)) * 256 + (ci & 15) * 16 +
           (co & 15);
  }
};
struct F32WeightIndex {  // [tap][ci][co]
  __device__ int operator()(int co, int ci, int tap) const {
    return (tap * kC + ci) * kC + co;
  }
};

// Launch 1: rearrange w (64, 64, 3, 3) into the kernel's shared-memory
// layout in a global scratch, once per call, so that every block of launch
// 2 stages it with plain 16-byte copies.
template <typename T, typename Index>
__global__ void pack_weights_kernel(const T* __restrict__ w,
                                    T* __restrict__ packed) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;   // (co*64+ci)*9+tap
  if (e < kTaps * kC * kC)
    packed[Index()(e / (kC * kTaps), (e / kTaps) % kC, e % kTaps)] = w[e];
}

// Copy the packed weights into shared memory, 16 bytes a thread.
template <typename T>
__device__ __forceinline__ void stage_weights(const T* __restrict__ packed,
                                              T* ws) {
  constexpr int kItems = kTaps * kC * kC * (int)sizeof(T) / 16;
  static_assert(kItems % (kBatch * kThreads) == 0, "staging batches");
  const uint4* src = reinterpret_cast<const uint4*>(packed);
  uint4* dst = reinterpret_cast<uint4*>(ws);
  for (int base = 0; base < kItems; base += kBatch * kThreads) {
    uint4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) v[u] = src[base + u * kThreads + threadIdx.x];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) dst[base + u * kThreads + threadIdx.x] = v[u];
  }
}

// Copy the tile (rows h0-1 .. h0+kTH, cols w0-1 .. w0+kTW, all channels) of
// x into shared memory, zero outside the image.
// NCHW: one element per thread, neighbours along w; dst(ci, r, c) gives the
// shared index.
template <typename T, typename Dst>
__device__ __forceinline__ void stage_tile_nchw(const T* __restrict__ x,
                                                T* xs, const Tile& tl, int H,
                                                int W, Dst dst) {
  constexpr int kItems = kHalo * kC;   // e = ci * kHalo + pixel
  static_assert(kItems % (kBatch * kThreads) == 0, "staging batches");
  for (int base = 0; base < kItems; base += kBatch * kThreads) {
    T v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = base + u * kThreads + threadIdx.x;
      const int p = e % kHalo, ci = e / kHalo;
      const int h = tl.h0 + p / kHW - 1, ww = tl.w0 + p % kHW - 1;
      v[u] = (h >= 0 && h < H && ww >= 0 && ww < W)
                 ? x[at<false>(tl.b, ci, h, ww, H, W)] : T(0);   // bf16 +0 is 0
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = base + u * kThreads + threadIdx.x;
      const int p = e % kHalo;
      xs[dst(e / kHalo, p / kHW, p % kHW)] = v[u];
    }
  }
}

// NHWC: 16 bytes of one pixel's channels (from channel ci on) per thread;
// put(v, ci, r, c) stores them.
template <typename T, typename Put>
__device__ __forceinline__ void stage_tile_nhwc(const T* __restrict__ x,
                                                const Tile& tl, int H, int W,
                                                Put put) {
  constexpr int kVec = 16 / sizeof(T), kChunks = kC / kVec;
  constexpr int kItems = kHalo * kChunks;   // e = pixel * kChunks + chunk
  constexpr int kB = (kItems + kThreads - 1) / kThreads;   // one round
  for (int base = 0; base < kItems; base += kB * kThreads) {
    uint4 v[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int e = base + u * kThreads + threadIdx.x;
      const int p = e / kChunks, ci = (e % kChunks) * kVec;
      const int h = tl.h0 + p / kHW - 1, ww = tl.w0 + p % kHW - 1;
      v[u] = (e < kItems && h >= 0 && h < H && ww >= 0 && ww < W)
                 ? *reinterpret_cast<const uint4*>(
                       x + at<true>(tl.b, ci, h, ww, H, W))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int e = base + u * kThreads + threadIdx.x;
      if (e >= kItems) break;
      const int p = e / kChunks;
      put(v[u], (e % kChunks) * kVec, p / kHW, p % kHW);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
conv3x3_bf16_nchw_kernel(const unsigned short* __restrict__ x,  // (B, 64, H, W)
                         const unsigned short* __restrict__ w,  // packed
                         const float* __restrict__ scale,       // (64,)
                         const float* __restrict__ bias,        // (64,)
                         __nv_bfloat16* __restrict__ out,       // (B, 64, H, W)
                         int H, int W, int tiles_h, int tiles_w, int tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned short* xs = reinterpret_cast<unsigned short*>(smem);
  unsigned short* ws = xs + kBfIn;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  stage_weights(w, ws);

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile tl = tile_of(t, tiles_h, tiles_w);
    stage_tile_nchw(x, xs, tl, H, W, [](int ci, int r, int c) {
      return (((ci >> 4) * kHH + r) * kHW + c) * 16 + (ci & 15);
    });
    __syncthreads();   // the tile (and, the first time, the weights) staged

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nc = 0; nc < 4; ++nc) wmma::fill_fragment(acc[i][nc], 0.f);
    const int r0 = warp * 2;   // this warp's two tile rows
    const __nv_bfloat16* xsb = reinterpret_cast<const __nv_bfloat16*>(xs);
    const __nv_bfloat16* wsb = reinterpret_cast<const __nv_bfloat16*>(ws);
#pragma unroll 1
    for (int tap = 0; tap < kTaps; ++tap) {
      const int kh = tap / 3, kw = tap % 3;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)   // rows: 16 pixels; cols: 16 channels
          wmma::load_matrix_sync(
              a[i], xsb + ((q * kHH + r0 + i + kh) * kHW + kw) * 16, 16);
#pragma unroll
        for (int nc = 0; nc < 4; ++nc) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> bf;
          wmma::load_matrix_sync(bf, wsb + ((tap * 4 + q) * 4 + nc) * 256, 16);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::mma_sync(acc[i][nc], a[i], bf, acc[i][nc]);
        }
      }
    }
    __syncthreads();   // every warp is done with xs: reuse it for the epilogue

    // one 16-pixel row at a time through scr[m * kScrLd + co]
    float* scr = reinterpret_cast<float*>(smem) + warp * 16 * kScrLd;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int h = tl.h0 + r0 + i;
#pragma unroll
      for (int nc = 0; nc < 4; ++nc)
        wmma::store_matrix_sync(scr + nc * 16, acc[i][nc], kScrLd,
                                wmma::mem_row_major);
      __syncwarp();
      if (h < H) {   // lanes along w, then channels
#pragma unroll 4
        for (int j = 0; j < 32; ++j) {
          const int e = lane + 32 * j, m = e & 15, co = e >> 4;
          if (tl.w0 + m < W)
            out[at<false>(tl.b, co, h, tl.w0 + m, H, W)] = __float2bfloat16(
                silu(fmaf(scr[m * kScrLd + co], scale[co], bias[co])));
        }
      }
      __syncwarp();
    }
    __syncthreads();   // the epilogue is done with xs before the next tile
  }
}

template <bool NHWC>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_f32_kernel(const float* __restrict__ x,
                   const float* __restrict__ w,             // packed
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int H, int W, int tiles_h, int tiles_w, int tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* ws = xs + kC * kHalo;
  const int lane = threadIdx.x & 31;
  const int cog = threadIdx.x >> 5;                  // channels cog*8 .. +7
  const int row = lane >> 1, c0 = (lane & 1) * 8;    // pixels c0 .. c0+7

  stage_weights(w, ws);

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile tl = tile_of(t, tiles_h, tiles_w);
    auto dst = [](int ci, int r, int c) { return (ci * kHH + r) * kHW + c; };
    if constexpr (NHWC)   // 4 channels of a pixel, one plane each
      stage_tile_nhwc(x, tl, H, W, [&](uint4 v, int ci, int r, int c) {
        xs[dst(ci, r, c)] = __uint_as_float(v.x);
        xs[dst(ci + 1, r, c)] = __uint_as_float(v.y);
        xs[dst(ci + 2, r, c)] = __uint_as_float(v.z);
        xs[dst(ci + 3, r, c)] = __uint_as_float(v.w);
      });
    else
      stage_tile_nchw(x, xs, tl, H, W, dst);
    __syncthreads();

    float acc[8][8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[j][k] = 0.f;
#pragma unroll 1
    for (int ci = 0; ci < kC; ++ci) {
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        const float* xr = xs + (ci * kHH + row + kh) * kHW + c0;
        float xv[10];
#pragma unroll
        for (int j = 0; j < 10; ++j) xv[j] = xr[j];
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const float4* wp = reinterpret_cast<const float4*>(
              ws + ((kh * 3 + kw) * kC + ci) * kC + cog * 8);
          const float4 wa = wp[0], wb = wp[1];
          const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int k = 0; k < 8; ++k)
              acc[j][k] = fmaf(xv[j + kw], wv[k], acc[j][k]);
        }
      }
    }

    const int h = tl.h0 + row;
    if (h < H) {
      float s[8], bb[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        s[k] = scale[cog * 8 + k];
        bb[k] = bias[cog * 8 + k];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ww = tl.w0 + c0 + j;
        if (ww >= W) break;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          out[at<NHWC>(tl.b, cog * 8 + k, h, ww, H, W)] =
              silu(fmaf(acc[j][k], s[k], bb[k]));
      }
    }
    __syncthreads();   // done with xs before the next tile is staged
  }
}

// Persistent grid: as many blocks as fit on the card at once, at most one
// per tile. The shared-memory opt-in and the occupancy are looked up once
// per kernel and device.
template <typename Kernel>
cudaError_t grid_size(Kernel kernel, size_t smem, int tiles, int* grid,
                      int* cache) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cache[dev] = sms * per_sm;
  }
  *grid = tiles < cache[dev] ? tiles : cache[dev];
  return cudaSuccess;
}

template <typename T, typename Index, typename O, typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int* cache, const void* x,
                   const void* w, void* packed, const float* s,
                   const float* b, void* out, int H, int W, int tiles_h,
                   int tiles_w, int tiles, cudaStream_t st) {
  int grid = 0;
  cudaError_t err = grid_size(kernel, smem, tiles, &grid, cache);
  if (err != cudaSuccess) return err;
  T* wp = static_cast<T*>(packed);
  pack_weights_kernel<T, Index><<<kTaps * kC * kC / kThreads, kThreads, 0,
                                  st>>>(static_cast<const T*>(w), wp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(static_cast<const T*>(x), wp, s, b,
                                       static_cast<O*>(out), H, W, tiles_h,
                                       tiles_w, tiles);
  return cudaGetLastError();
}

int g_grid[3][kMaxDevices];   // [bf16 NCHW, fp32 NCHW, fp32 NHWC][device]

}  // namespace

// x, out: (B, 64, H, W), bf16 (is_bf16) or fp32, both dense in NCHW or both
// in NHWC (channels_last, nhwc = 1), x 16-byte aligned; w: (64, 64, 3, 3)
// in x's dtype, 16-byte aligned; packed: a 16-byte aligned scratch of
// 64 * 64 * 9 elements of x's dtype (not read for bf16 NHWC, may be null
// there); scale, bias: (64,) fp32.
extern "C" int icaf_conv3x3_bn_silu(const void* x, const void* w,
                                    void* packed, const void* scale,
                                    const void* bias, void* out, int B,
                                    int H, int W, int is_bf16, int nhwc,
                                    void* stream) {
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  auto s = static_cast<const float*>(scale);
  auto b = static_cast<const float*>(bias);
  if (is_bf16 && nhwc) return nhwc::launch(x, w, s, b, out, B, H, W, st);
  const int tiles_h = (H + kTH - 1) / kTH, tiles_w = (W + kTW - 1) / kTW;
  const int tiles = B * tiles_h * tiles_w;
  using u16 = unsigned short;
  if (is_bf16)
    return launch<u16, BfWeightIndex, __nv_bfloat16>(
        conv3x3_bf16_nchw_kernel, kBfSmem, g_grid[0], x, w, packed, s, b, out,
        H, W, tiles_h, tiles_w, tiles, st);
  if (nhwc)
    return launch<float, F32WeightIndex, float>(
        conv3x3_f32_kernel<true>, kF32Smem, g_grid[2], x, w, packed, s, b,
        out, H, W, tiles_h, tiles_w, tiles, st);
  return launch<float, F32WeightIndex, float>(
      conv3x3_f32_kernel<false>, kF32Smem, g_grid[1], x, w, packed, s, b, out,
      H, W, tiles_h, tiles_w, tiles, st);
}
