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
// even (__float2int_rn, as jnp.round), then the clamp. The epilogue is
// fp32 with explicit _rn operations (no FMA contraction), rounded once to
// the output dtype, so it equals the plain version's fp32 arithmetic.
//
// What bounds it on the H100: a yolov5l-Transfusion forward at 640 is about
// 91 GMAC an image, 0.09 ms an image at the 1979 TOPS int8 dense peak; the
// 3x3 convs of P4/P5 are operation-bound, the 1x1 convs and the stem
// byte-bound. This first design is bound by neither: it quantizes every
// input element once per tap and per 128 output channels on the CUDA cores
// (one IEEE division each), which is the work that bounds it, and
// multiplies with mma.sync, not wgmma (chip_smoke.py phase 11b on an H100
// 80GB HBM3 at 700 W: the 162 int8 convs of a batch-4 forward take about
// 15 ms against a summed bound of 0.77 ms). Quantizing each input element
// once a block (a spatial tile with its halo), wgmma with .s8 operands,
// TMA and a persistent schedule are for a later PR.
//
// Design: an implicit GEMM, M = B*Ho*Wo output pixels, N = Cout,
// K = kh*kw*Cin in (ky, kx, ci) order (w8's own order, so B rows are w8's
// rows). A block computes a 64-pixel x 128-channel tile with 8 warps (2 x 4,
// 32 x 32 each: 2 x 4 m16n8k32 tiles), stepping K by 64 bytes through two
// shared-memory buffers: the global loads of step k+1 are issued before the
// products of step k and stored (A quantized on the way) after them, one
// barrier a step. A thread loads one K column of A for 16 pixels (a warp
// reads 32 consecutive channels of a pixel: coalesced in channels_last),
// and two 16-byte chunks of B (byte loads where K is not a multiple of 16:
// the 3-channel stem, K = 108). Rows are 80 bytes apart in shared memory,
// which makes the fragment loads free of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

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
  int act;                       // 1: SiLU, 0: identity
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int quantize(float v, float s) {
  const int q = __float2int_rn(__fdiv_rn(v, s));
  return min(max(q, -127), 127);
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
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
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
    if (n < p.Cout) {
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
  float a_scale = 1.f;
  uint4 b_val[kBChunks];

  auto load = [&](int kt) {
    const int k = kt * kBK + a_col;
    if (k < p.K) {
      const int ci = k % p.Cin, tap = k / p.Cin;
      const int kx = tap % p.kw, ky = tap / p.kw;
      const long long col_off = ci * p.sc + ky * p.sh + kx * p.sw;
      a_scale = p.s_in[ci];
#pragma unroll
      for (int i = 0; i < kAPerThread; ++i) {
        const int r = a_row + i * kARows;
        const int h = row_h[r] + ky, w = row_w[r] + kx;
        a_val[i] = (h >= 0 && h < p.H && w >= 0 && w < p.W)
                       ? to_float(x[row_off[r] + col_off])
                       : 0.f;
      }
    } else {
      a_scale = 1.f;
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
        b_val[j] = (n < p.Cout && k0 < p.K)
                       ? *reinterpret_cast<const uint4*>(row + k0)
                       : make_uint4(0, 0, 0, 0);
      } else {
        uint32_t v[4] = {0, 0, 0, 0};
        if (n < p.Cout) {
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
#pragma unroll
    for (int i = 0; i < kAPerThread; ++i) {
      const int r = a_row + i * kARows;
      As[buf][r * kRow + a_col] =
          static_cast<int8_t>(quantize(a_val[i], a_scale));
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
        if (m >= p.M || n >= p.Cout) continue;
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
  const dim3 grid((p.M + kBM - 1) / kBM, (p.Cout + kBN - 1) / kBN);
  if (epilogue)
    conv_int8_kernel<T, true><<<grid, kThreads, 0, st>>>(p);
  else
    conv_int8_kernel<T, false><<<grid, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x with element strides (sb, sc, sh, sw); w8 (Cout, kh, kw, Cin) int8;
// s_in (Cin,), s_w and the BatchNorm's gamma, beta, mean, var (Cout,)
// float32; out (B, Ho, Wo, Cout) dense: x's dtype, or int32 when
// epilogue = 0. kh is implied by K = kh*kw*Cin (the rows of w8).
extern "C" int icaf_conv_int8(const void* x, long long sb, long long sc,
                              long long sh, long long sw, const void* w8,
                              const void* s_in, const void* s_w,
                              const void* gamma, const void* beta,
                              const void* mean, const void* var, float eps,
                              void* out, int B, int Cin, int H, int W,
                              int Cout, int kh, int kw, int stride_h,
                              int stride_w, int pad_h, int pad_w, int Ho,
                              int Wo, int is_bf16, int act, int epilogue,
                              void* stream) {
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
  p.K = kh * kw * Cin;
  p.act = act;
  if (p.M == 0 || Cout == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(p, epilogue, st)
                 : launch<float>(p, epilogue, st);
}
