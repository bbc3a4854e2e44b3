// The arithmetic that every path of the int8 conv shares (conv_int8.cu,
// conv_int8_small.cu): the input's quantization, bit for bit the JAX
// package's, and the fp32 epilogue, in the plain version's order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace icaf_int8 {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// An element of x as its raw bits (fp32, or bf16 in the low half), and
// back: a load whose value is needed only later keeps no conversion
// waiting on it.
__device__ __forceinline__ uint32_t load_bits(const float* p) {
  return __float_as_uint(__ldg(p));
}
__device__ __forceinline__ uint32_t load_bits(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}
template <typename T>
__device__ __forceinline__ float bits_to_float(uint32_t b) {
  return sizeof(T) == 2 ? __uint_as_float(b << 16) : __uint_as_float(b);
}

__device__ __forceinline__ int quantize(float v, float s) {
  const int q = __float2int_rn(__fdiv_rn(v, s));
  return min(max(q, -127), 127);
}

// quantize(v[e], s(e)) of N values, without a division where none is
// needed. r(e) = rn(1 / s(e)) and y = rn(v * r) lie within 2^-23 |v / s| of
// v / s, and rn(v / s) within 2^-24 |v / s|: for |y| < 256 the two are
// less than 4.6e-5 apart, so where y is more than 1e-4 from the nearest
// half-integer they round (half to even) to the same integer; for larger
// |y| both clamp to the same end. The N products are rounded together,
// with no branch between them; then the IEEE division decides each value
// that is near a half-integer (or NaN). Bit for bit quantize(v, s). bf16
// inputs and their absmax scales land near half-integers far more often
// than smooth values would, so the division runs for those values alone.
template <int N, typename S, typename R>
__device__ __forceinline__ void quantize_n(const float (&v)[N], S s, R r,
                                           int (&q)[N]) {
  bool near[N];
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float y = __fmul_rn(v[e], r(e));
    const float yr = rintf(y);
    near[e] = !(fabsf(y - yr) < 0.4999f);
    q[e] = __float2int_rn(fminf(fmaxf(yr, -127.f), 127.f));
  }
#pragma unroll
  for (int e = 0; e < N; ++e)
    if (near[e]) q[e] = quantize(v[e], s(e));
}

// mult = s_w * gamma / sqrt(var + eps), add = beta - mean * gamma / sqrt(..)
__device__ __forceinline__ void fold(int n, const float* s_w,
                                     const float* gamma, const float* beta,
                                     const float* mean, const float* var,
                                     float eps, float& mult, float& add) {
  const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var[n], eps)));
  const float g = __fmul_rn(gamma[n], inv);
  mult = __fmul_rn(s_w[n], g);
  add = __fsub_rn(beta[n], __fmul_rn(mean[n], g));
}

// act(acc * mult + add), in the plain version's fp32 order; SiLU as
// y / (1 + exp(-y)).
__device__ __forceinline__ float epilogue(int acc, float mult, float add,
                                          int act) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), mult), add);
  if (act) y = __fdiv_rn(y, __fadd_rn(1.f, expf(-y)));
  return y;
}

// 8 consecutive channels of x at src (16-byte aligned) as raw words, one
// uint4 for bf16 and two for fp32; zeros where !ok (the conv's padding).
template <typename T>
struct Raw8 {
  static constexpr int kWords = sizeof(T) / 2;
  uint4 w[kWords];
};
template <typename T>
__device__ __forceinline__ void load8(const T* src, bool ok, Raw8<T>& r) {
#pragma unroll
  for (int i = 0; i < Raw8<T>::kWords; ++i)
    r.w[i] = ok ? __ldg(reinterpret_cast<const uint4*>(src) + i)
                : make_uint4(0, 0, 0, 0);
}
__device__ __forceinline__ void unpack8(const Raw8<__nv_bfloat16>& r,
                                        float (&v)[8]) {
  const uint32_t u[4] = {r.w[0].x, r.w[0].y, r.w[0].z, r.w[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack8(const Raw8<float>& r, float (&v)[8]) {
  const uint4 (&w)[2] = r.w;
  v[0] = __uint_as_float(w[0].x); v[1] = __uint_as_float(w[0].y);
  v[2] = __uint_as_float(w[0].z); v[3] = __uint_as_float(w[0].w);
  v[4] = __uint_as_float(w[1].x); v[5] = __uint_as_float(w[1].y);
  v[6] = __uint_as_float(w[1].z); v[7] = __uint_as_float(w[1].w);
}

// 8 values quantized (quantize_n) and packed into two words.
__device__ __forceinline__ void quantize8(const float (&v)[8],
                                          const float (&s)[8],
                                          const float (&r)[8],
                                          uint32_t (&q8)[2]) {
  int q[8];
  quantize_n(v, [&](int e) { return s[e]; }, [&](int e) { return r[e]; }, q);
  q8[0] = q8[1] = 0u;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    q8[e >> 2] |= (static_cast<uint32_t>(q[e]) & 0xffu) << ((e & 3) * 8);
}

}  // namespace icaf_int8
