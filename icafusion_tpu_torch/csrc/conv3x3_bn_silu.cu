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
// that packing is not carried over.
//
// It is an implicit GEMM: M = B*H*W pixels, N = 64 output channels,
// K = 576 = 64 * 3 * 3, in two launches: a small one rearranges the weights
// into the layout below in a global scratch; then each block copies the
// whole 576 x 64 weight matrix into shared memory with 16-byte loads (once:
// blocks are persistent and walk over the output tiles), stages one 16 x 16-pixel tile with its 1-pixel halo for all 64
// input channels, masking the ragged edge and the zero pad itself (16-byte
// loads of a pixel's channels in NHWC, one element a thread along w in
// NCHW), and multiplies from shared memory:
//   bf16  tensor cores, WMMA 16x16x16 with fp32 accumulation. Each of the 8
//         warps computes two 16-pixel rows by 64 channels. Both operands
//         are stored as contiguous 16 x 16 blocks (channel-minor input,
//         k-minor weights), so every fragment pointer is 32-byte aligned.
//         115,200 bytes of shared memory: two blocks per SM.
//   fp32  CUDA-core FMAs, no TF32 (so it matches a plain version run with
//         cudnn.allow_tf32 off). Each thread computes 8 pixels by 8
//         channels. 230,400 bytes of shared memory: one block per SM.
// The epilogue applies acc * scale + bias and SiLU in fp32 and stores in
// the input dtype and layout (NHWC: a warp writes a pixel's 128 bytes).
//
// What bounds it on the H100: at the flagship shape x = (4, 64, 160, 160)
// bf16 the work is 7.55 GFLOP (7.6 us at 989 TFLOP/s) against 26.2 MB of
// activations in and out plus 74 KB of weights (7.9 us at 3.35 TB/s), so
// bytes and operations bound it about equally. This first version uses
// mma.sync-class WMMA without TMA, wgmma or a pipelined staging of the next
// tile, so it runs well above that bound; those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kC = 64;                     // channels in and out
constexpr int kTaps = 9;
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

__device__ __forceinline__ float silu(float y) { return y / (1.f + expf(-y)); }

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

template <bool NHWC>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_bf16_kernel(const unsigned short* __restrict__ x,   // (B, 64, H, W)
                    const unsigned short* __restrict__ w,   // packed
                    const float* __restrict__ scale,        // (64,)
                    const float* __restrict__ bias,         // (64,)
                    __nv_bfloat16* __restrict__ out,        // (B, 64, H, W)
                    int H, int W, int tiles_h, int tiles_w, int tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned short* xs = reinterpret_cast<unsigned short*>(smem);
  unsigned short* ws = xs + kBfIn;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  stage_weights(w, ws);

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile tl = tile_of(t, tiles_h, tiles_w);
    auto dst = [](int ci, int r, int c) {
      return (((ci >> 4) * kHH + r) * kHW + c) * 16 + (ci & 15);
    };
    if constexpr (NHWC)   // 8 channels from a multiple of 8: 16 contiguous bytes
      stage_tile_nhwc(x, tl, H, W, [&](uint4 v, int ci, int r, int c) {
        *reinterpret_cast<uint4*>(xs + dst(ci, r, c)) = v;
      });
    else
      stage_tile_nchw(x, xs, tl, H, W, dst);
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
      if (h < H) {
        if constexpr (NHWC) {   // a lane stores channels 2 lane, 2 lane + 1 of a pixel
          const int co = 2 * lane;
          const float s0 = scale[co], s1 = scale[co + 1];
          const float b0 = bias[co], b1 = bias[co + 1];
          for (int m = 0; m < kTW && tl.w0 + m < W; ++m) {
            const float2 a = *reinterpret_cast<const float2*>(
                scr + m * kScrLd + co);
            *reinterpret_cast<__nv_bfloat162*>(
                out + at<true>(tl.b, co, h, tl.w0 + m, H, W)) =
                __floats2bfloat162_rn(silu(fmaf(a.x, s0, b0)),
                                      silu(fmaf(a.y, s1, b1)));
          }
        } else {      // lanes along w, then channels
#pragma unroll 4
          for (int j = 0; j < 32; ++j) {
            const int e = lane + 32 * j, m = e & 15, co = e >> 4;
            if (tl.w0 + m < W)
              out[at<false>(tl.b, co, h, tl.w0 + m, H, W)] = __float2bfloat16(
                  silu(fmaf(scr[m * kScrLd + co], scale[co], bias[co])));
          }
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

constexpr int kMaxDevices = 64;

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

int g_grid[4][kMaxDevices];   // [is_bf16 * 2 + nhwc][device]

}  // namespace

// x, out: (B, 64, H, W), bf16 (is_bf16) or fp32, both dense in NCHW or both
// in NHWC (channels_last, nhwc = 1), x 16-byte aligned; w: (64, 64, 3, 3)
// in x's dtype; packed: a 16-byte aligned scratch of 64 * 64 * 9 elements
// of x's dtype; scale, bias: (64,) fp32.
extern "C" int icaf_conv3x3_bn_silu(const void* x, const void* w,
                                    void* packed, const void* scale,
                                    const void* bias, void* out, int B,
                                    int H, int W, int is_bf16, int nhwc,
                                    void* stream) {
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  const int tiles_h = (H + kTH - 1) / kTH, tiles_w = (W + kTW - 1) / kTW;
  const int tiles = B * tiles_h * tiles_w;
  auto st = static_cast<cudaStream_t>(stream);
  auto s = static_cast<const float*>(scale);
  auto b = static_cast<const float*>(bias);
  int* cache = g_grid[is_bf16 * 2 + nhwc];
  using u16 = unsigned short;
  if (is_bf16 && nhwc)
    return launch<u16, BfWeightIndex, __nv_bfloat16>(
        conv3x3_bf16_kernel<true>, kBfSmem, cache, x, w, packed, s, b, out,
        H, W, tiles_h, tiles_w, tiles, st);
  if (is_bf16)
    return launch<u16, BfWeightIndex, __nv_bfloat16>(
        conv3x3_bf16_kernel<false>, kBfSmem, cache, x, w, packed, s, b, out,
        H, W, tiles_h, tiles_w, tiles, st);
  if (nhwc)
    return launch<float, F32WeightIndex, float>(
        conv3x3_f32_kernel<true>, kF32Smem, cache, x, w, packed, s, b, out,
        H, W, tiles_h, tiles_w, tiles, st);
  return launch<float, F32WeightIndex, float>(
      conv3x3_f32_kernel<false>, kF32Smem, cache, x, w, packed, s, b, out, H,
      W, tiles_h, tiles_w, tiles, st);
}
