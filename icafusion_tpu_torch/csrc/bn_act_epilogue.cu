// Eval-mode BatchNorm affine + activation, in place, over the output of a
// library convolution:
//   y[i] = act(fmaf(y[i], scale[c], bias[c])),  act = SiLU or identity,
// with c = i % C where y is channels_last (NHWC in memory) and
// c = (i / HW) % C where it is NCHW; fp32 arithmetic, one rounding to y's
// dtype (bf16 or fp32), as the fused conv's epilogue rounds
// (conv3x3_bn_silu.cu: silu_fast in bf16, the exact silu in fp32).
// (scale, bias) is the BatchNorm folded once into float32 (ops/fuse.py:
// fold_bn_act) by the serving engine.
//
// Replaces no Pallas kernel: on the TPU, XLA fuses the eval BatchNorm and
// the SiLU into the convolution before them (icafusion_tpu/nn/layers.py:
// Conv). The port's convs off the int8 and fused 64-channel paths run on
// cuDNN, which writes the conv's output; without this kernel PyTorch's
// BatchNorm and SiLU then read and write it once each.
//
// What bounds it on the H100: bytes. It reads and writes y once, 2 x y's
// bytes at 3.35 TB/s (a bf16 (32, 128, 160, 160) map: 2 x 210 MB, 125 us);
// its 2-3 flops an element are nothing beside that. So the design only
// keeps enough bytes in flight, as PyTorch's own elementwise kernels do:
// one 16-byte load and store a thread, one block of 256 threads for every
// 256 vectors, so that the hardware schedules blocks onto SMs as they free
// up; the channel of a vector found with 32-bit index arithmetic (maps of
// 2^31 elements or more, 4 GB in bf16, are refused: no served map comes
// near).
// (A persistent grid of 8 blocks an SM, two vectors a thread, read 70 % of
// the bound at a served forward's maps where this reads 79 % and
// F.silu_ 81 %: with 38 registers a thread only 6 of the 8 blocks fit.)
// Three modes, chosen by the C entry:
//   kNhwc  channels_last, C a multiple of the vector (8 bf16, 4 fp32): a
//          vector holds channels c0..c0+N-1 of one pixel, so scale and bias
//          come as 16-byte loads too (every serving map);
//   kNchw  NCHW, H*W a multiple of the vector: one channel a vector;
//   kAny   every other shape: the channel of each element, stepped from
//          the vector's first, and a scalar tail past the last vector.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxElements = 1LL << 31;   // every index fits 32 bits

enum Mode { kNhwc = 0, kNchw = 1, kAny = 2 };

__device__ __forceinline__ float silu_fast(float v) {
  return __fdividef(v, 1.f + __expf(-v));   // -0 for v below about -88
}
__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, bool kSilu>
__device__ __forceinline__ T apply(T v, float s, float b) {
  float r = fmaf(to_f(v), s, b);
  if (kSilu) r = std::is_same<T, float>::value ? silu(r) : silu_fast(r);
  return from_f<T>(r);
}

// 16 bytes of T
template <typename T>
union Vec {
  static constexpr int N = 16 / sizeof(T);
  uint4 raw;
  T v[N];
};

// The vectors are [0, nvec); elements [nvec * N, n) are the tail. n is
// below 2^31, so no index, nor the tail's nvec * N + threadIdx.x, wraps.
template <typename T, bool kSilu, int kMode>
__global__ void __launch_bounds__(kThreads)
    bn_act_kernel(T* __restrict__ y, const float* __restrict__ scale,
                  const float* __restrict__ bias, uint32_t n, uint32_t C,
                  uint32_t HW) {
  constexpr int N = Vec<T>::N;
  const uint32_t nvec = n / N;
  const uint32_t step = gridDim.x * kThreads;
  uint4* yv = reinterpret_cast<uint4*>(y);
  for (uint32_t v = blockIdx.x * kThreads + threadIdx.x; v < nvec;
       v += step) {
    Vec<T> x;
    x.raw = yv[v];
    if (kMode == kNhwc) {
      const uint32_t c0 = (v % (C / N)) * N;
      float s[N], b[N];
#pragma unroll
      for (int k = 0; k < N; k += 4) {
        const float4 s4 = __ldg(reinterpret_cast<const float4*>(scale + c0 + k));
        const float4 b4 = __ldg(reinterpret_cast<const float4*>(bias + c0 + k));
        s[k] = s4.x, s[k + 1] = s4.y, s[k + 2] = s4.z, s[k + 3] = s4.w;
        b[k] = b4.x, b[k + 1] = b4.y, b[k + 2] = b4.z, b[k + 3] = b4.w;
      }
#pragma unroll
      for (int k = 0; k < N; ++k) x.v[k] = apply<T, kSilu>(x.v[k], s[k], b[k]);
    } else if (kMode == kNchw) {
      const uint32_t c = (v / (HW / N)) % C;
      const float s = __ldg(scale + c), b = __ldg(bias + c);
#pragma unroll
      for (int k = 0; k < N; ++k) x.v[k] = apply<T, kSilu>(x.v[k], s, b);
    } else {
      // the first element's channel (and, in NCHW, its place in the
      // plane), then one step an element
      const uint32_t i = v * N;
      uint32_t c, p = 0;
      if (HW == 0) {
        c = i % C;
      } else {
        const uint32_t q = i / HW;
        p = i - q * HW;
        c = q % C;
      }
#pragma unroll
      for (int k = 0; k < N; ++k) {
        x.v[k] = apply<T, kSilu>(x.v[k], __ldg(scale + c), __ldg(bias + c));
        if (HW == 0) {
          if (++c == C) c = 0;
        } else if (++p == HW) {
          p = 0;
          if (++c == C) c = 0;
        }
      }
    }
    yv[v] = x.raw;
  }
  if (kMode == kAny && blockIdx.x == 0) {   // the scalar tail, under N
    const uint32_t i = nvec * N + threadIdx.x;
    if (i < n) {
      const uint32_t c = HW == 0 ? i % C : (i / HW) % C;
      y[i] = apply<T, kSilu>(y[i], __ldg(scale + c), __ldg(bias + c));
    }
  }
}

template <typename T, bool kSilu, int kMode>
cudaError_t launch_typed(void* y, const float* s, const float* b,
                         long long n, long long C, long long HW,
                         cudaStream_t st) {
  const long long nvec = n / Vec<T>::N;
  long long blocks = (nvec + kThreads - 1) / kThreads;   // under 2^21
  if (blocks < 1) blocks = 1;   // the tail
  bn_act_kernel<T, kSilu, kMode>
      <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
          static_cast<T*>(y), s, b, static_cast<uint32_t>(n),
          static_cast<uint32_t>(C), static_cast<uint32_t>(HW));
  return cudaGetLastError();
}

template <typename T, bool kSilu>
cudaError_t launch_mode(void* y, const float* s, const float* b, long long n,
                        long long C, long long HW, bool nhwc,
                        cudaStream_t st) {
  constexpr int N = Vec<T>::N;
  if (nhwc && C % N == 0)
    return launch_typed<T, kSilu, kNhwc>(y, s, b, n, C, HW, st);
  if (!nhwc && HW % N == 0)
    return launch_typed<T, kSilu, kNchw>(y, s, b, n, C, HW, st);
  // kAny marks channels_last by HW = 0
  return launch_typed<T, kSilu, kAny>(y, s, b, n, C, nhwc ? 0 : HW, st);
}

}  // namespace

// y: n elements (under 2^31), C channels, HW = H * W, in place; scale,
// bias: C float32 (kernels/bn_act.py: check_affine). flags: bit 0 y is
// bf16 (else fp32), bit 1 channels_last (else NCHW), bit 2 SiLU (else the
// identity). y, scale and bias 16-byte aligned, else refused.
extern "C" int icaf_bn_act(void* y, const void* scale, const void* bias,
                           long long n, long long C, long long HW, int flags,
                           void* stream) {
  if (n == 0) return cudaSuccess;
  if (C < 1 || HW < 1 || n % (C * HW) != 0 || n >= kMaxElements)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(y) % 16 ||
      reinterpret_cast<uintptr_t>(scale) % 16 ||
      reinterpret_cast<uintptr_t>(bias) % 16)
    return cudaErrorMisalignedAddress;
  auto st = static_cast<cudaStream_t>(stream);
  auto s = static_cast<const float*>(scale);
  auto b = static_cast<const float*>(bias);
  const bool is_bf16 = flags & 1, cl = flags & 2, silu = flags & 4;
  if (is_bf16)
    return silu ? launch_mode<__nv_bfloat16, true>(y, s, b, n, C, HW, cl, st)
                : launch_mode<__nv_bfloat16, false>(y, s, b, n, C, HW, cl, st);
  return silu ? launch_mode<float, true>(y, s, b, n, C, HW, cl, st)
              : launch_mode<float, false>(y, s, b, n, C, HW, cl, st);
}
