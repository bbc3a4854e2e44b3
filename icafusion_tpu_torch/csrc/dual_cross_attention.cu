// Fused dual cross-attention with its six projections (fp32 or bf16 in,
// fp32 accumulation and softmax, output in the input dtype).
//
// Replaces the Pallas TPU kernel icafusion_tpu/kernels/cross_attention.py:
// dual_cross_attention (body _dca_kernel). For tokens vis, ir (B, N, D),
// h heads of width dk = D / h:
//   q/k/v_vis = vis W^T + b,  q/k/v_ir = ir W^T + b     (six projections)
//   out_vis = softmax(q_ir  k_vis^T / sqrt(dk)) v_vis
//   out_ir  = softmax(q_vis k_ir^T  / sqrt(dk)) v_ir
// out_* are (B, N, D), heads concatenated, before the output projections.
//
// What bounds it on the H100: operations. Per image pair the main path
// (N, D) = (400, 256), (256, 512), (100, 1024) needs 2.38 GFLOP of
// projections and 0.68 GFLOP of attention, against 8.26 M weight values
// (16.5 MB in bf16) that every image reuses, so at batch 4 the bound is the
// tensor cores' rate: about 12 us in all at 989 TFLOP/s bf16. This first
// version uses CUDA cores only (no wgmma, no TMA) and is far from that
// bound; it is written to be right and simple:
//   launch 1  a tiled shared-memory GEMM (64 x 64 tiles, 4 x 4 outputs per
//             thread) computes all six projections, one grid z-slice each,
//             into an fp32 scratch (6, B, h, N, dk), kept in fp32 as the
//             Pallas kernel keeps q/k/v;
//   launch 2  one block per (64-query tile, head, batch x direction) runs an
//             online softmax over 64-key tiles of K and V staged in shared
//             memory; four threads share a query row, so the score, max and
//             sum reductions stay inside a warp.
// Both launches cover both directions. The N x N logits never reach device
// memory; q/k/v make one round trip through the scratch (L2-resident at
// these sizes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch casts
}

struct ProjArgs {
  const void* x[2];      // vis, ir: (B*N, D)
  const void* w[6];      // (D, D) torch Linear layout (out, in)
  const float* b[6];     // (D,)
  float* qkv;            // (6, B, H, N, dk)
  int M, N, D, H, dk;    // M = B * N
};

constexpr int kBM = 64, kBN = 64, kBK = 16, kProjThreads = 256;

// out[z][row][col] = sum_k X[row][k] * W_z[col][k] + b_z[col], scattered to
// the per-head layout. z = 0..5 in the order q_vis k_vis v_vis q_ir k_ir v_ir.
template <typename T>
__global__ void __launch_bounds__(kProjThreads)
projections_kernel(ProjArgs a) {
  const int z = blockIdx.z;
  const T* __restrict__ X = static_cast<const T*>(a.x[z / 3]);
  const T* __restrict__ W = static_cast<const T*>(a.w[z]);
  const float* __restrict__ bias = a.b[z];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;      // 4 x 4 outputs each

  __shared__ __align__(16) float As[kBK][kBM];   // As[k][row]
  __shared__ __align__(16) float Bs[kBK][kBN];   // Bs[k][col]

  float acc[4][4] = {};
  const int lrow = tid / 4, lk = (tid % 4) * 4;  // loader: 4 k per thread
  for (int k0 = 0; k0 < a.D; k0 += kBK) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + lk + e;
      const int gm = m0 + lrow, gn = n0 + lrow;
      As[lk + e][lrow] =
          (gm < a.M && k < a.D) ? to_f32(X[(size_t)gm * a.D + k]) : 0.f;
      Bs[lk + e][lrow] =
          (gn < a.D && k < a.D) ? to_f32(W[(size_t)gn * a.D + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += ar[i] * br[j];
    }
    __syncthreads();
  }
  const int B = a.M / a.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= a.M) continue;
    const int bb = row / a.N, n = row % a.N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= a.D) continue;
      const int h = col / a.dk, d = col % a.dk;
      a.qkv[((((size_t)z * B + bb) * a.H + h) * a.N + n) * a.dk + d] =
          acc[i][j] + bias[col];
    }
  }
}

struct AttnArgs {
  const float* qkv;      // (6, B, H, N, dk)
  void* out[2];          // out_vis, out_ir: (B, N, D)
  int B, N, H, dk;
  float scale;           // 1 / sqrt(dk)
};

constexpr int kBQ = 64, kBKV = 64, kAttnThreads = 256;  // 4 threads / query

template <int DKP>   // dk padded up to 32, 64 or 128
constexpr int attn_smem_floats() {
  return 3 * 64 * (DKP + 1) + 64 * (kBKV + 1);
}

// grid: (ceil(N / 64), H, B * 2); blockIdx.z = b * 2 + direction.
// direction 0: out_vis = softmax(q_ir k_vis^T) v_vis; 1: out_ir, q_vis k_ir v_ir
template <typename T, int DKP>
__global__ void __launch_bounds__(kAttnThreads)
attention_kernel(AttnArgs a) {
  extern __shared__ float smem[];
  constexpr int LD = DKP + 1;          // padded rows: conflict-free columns
  float* Qs = smem;                     // [64][LD]
  float* Ks = Qs + kBQ * LD;            // [64][LD]
  float* Vs = Ks + kBKV * LD;           // [64][LD]
  float* Ps = Vs + kBKV * LD;           // [64][kBKV + 1]

  const int dir = blockIdx.z & 1, b = blockIdx.z >> 1, h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, qr = tid / 4, sub = tid % 4;
  const int N = a.N, dk = a.dk;
  const int zq = dir == 0 ? 3 : 0, zk = dir == 0 ? 1 : 4, zv = zk + 1;
  const size_t head = (size_t)N * dk;
  const float* Qg = a.qkv + (((size_t)zq * a.B + b) * a.H + h) * head;
  const float* Kg = a.qkv + (((size_t)zk * a.B + b) * a.H + h) * head;
  const float* Vg = a.qkv + (((size_t)zv * a.B + b) * a.H + h) * head;

  for (int e = tid; e < kBQ * DKP; e += kAttnThreads) {
    const int r = e / DKP, d = e % DKP;
    Qs[r * LD + d] = (q0 + r < N && d < dk) ? Qg[(size_t)(q0 + r) * dk + d] : 0.f;
  }

  constexpr int KPT = kBKV / 4;        // keys per thread: j = sub + 4 * jj
  constexpr int DPT = DKP / 4;         // output dims per thread: sub + 4 * dd
  float acc[DPT];
#pragma unroll
  for (int dd = 0; dd < DPT; ++dd) acc[dd] = 0.f;
  float m = -INFINITY, l = 0.f;        // running max; this thread's share of l

  for (int k0 = 0; k0 < N; k0 += kBKV) {
    __syncthreads();                   // previous tile's K/V/P reads done
    for (int e = tid; e < kBKV * DKP; e += kAttnThreads) {
      const int r = e / DKP, d = e % DKP;
      const bool in = k0 + r < N && d < dk;
      Ks[r * LD + d] = in ? Kg[(size_t)(k0 + r) * dk + d] : 0.f;
      Vs[r * LD + d] = in ? Vg[(size_t)(k0 + r) * dk + d] : 0.f;
    }
    __syncthreads();

    float s[KPT];
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) s[jj] = 0.f;
    for (int d = 0; d < DKP; ++d) {
      const float qd = Qs[qr * LD + d];
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) s[jj] += qd * Ks[(sub + 4 * jj) * LD + d];
    }
    float tmax = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      s[jj] = (k0 + sub + 4 * jj < N) ? s[jj] * a.scale : -INFINITY;
      tmax = fmaxf(tmax, s[jj]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);        // finite: key k0 is valid
    const float alpha = expf(m - m_new);       // 0 on the first tile
    m = m_new;
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const float p = expf(s[jj] - m_new);     // 0 for masked keys
      psum += p;
      Ps[qr * (kBKV + 1) + sub + 4 * jj] = p;
    }
    l = l * alpha + psum;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) acc[dd] *= alpha;
    __syncwarp();                      // a query's 4 threads share one warp
    const int kn = min(kBKV, N - k0);
    for (int j = 0; j < kn; ++j) {
      const float p = Ps[qr * (kBKV + 1) + j];
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) acc[dd] += p * Vs[j * LD + sub + 4 * dd];
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  const int q = q0 + qr;
  if (q >= N) return;
  T* out = static_cast<T*>(a.out[dir]) + ((size_t)b * N + q) * (a.H * dk) + h * dk;
  const float inv = 1.f / l;
#pragma unroll
  for (int dd = 0; dd < DPT; ++dd) {
    const int d = sub + 4 * dd;
    if (d < dk) out[d] = from_f32<T>(acc[dd] * inv);
  }
}

template <typename T, int DKP>
cudaError_t launch_attention(const AttnArgs& a, cudaStream_t stream) {
  constexpr int smem = attn_smem_floats<DKP>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<T, DKP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.N + kBQ - 1) / kBQ, a.H, a.B * 2);
  attention_kernel<T, DKP><<<grid, kAttnThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const ProjArgs& p, const AttnArgs& a, cudaStream_t stream) {
  dim3 grid((p.M + kBM - 1) / kBM, (p.D + kBN - 1) / kBN, 6);
  projections_kernel<T><<<grid, kProjThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.dk <= 32) return launch_attention<T, 32>(a, stream);
  if (a.dk <= 64) return launch_attention<T, 64>(a, stream);
  if (a.dk <= 128) return launch_attention<T, 128>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int icaf_dual_cross_attention(
    const void* vis, const void* ir, const void* weights, const void* biases,
    void* qkv, void* out_vis, void* out_ir, int B, int N, int D, int H,
    int is_bf16, void* stream) {
  if (B == 0 || N == 0) return cudaSuccess;
  // weights / biases: host arrays of six device pointers each
  const void* const* w = static_cast<const void* const*>(weights);
  const void* const* bs = static_cast<const void* const*>(biases);
  ProjArgs p;
  p.x[0] = vis;
  p.x[1] = ir;
  for (int i = 0; i < 6; ++i) {
    p.w[i] = w[i];
    p.b[i] = static_cast<const float*>(bs[i]);
  }
  p.qkv = static_cast<float*>(qkv);
  p.M = B * N;
  p.N = N;
  p.D = D;
  p.H = H;
  p.dk = D / H;
  AttnArgs a;
  a.qkv = p.qkv;
  a.out[0] = out_vis;
  a.out[1] = out_ir;
  a.B = B;
  a.N = N;
  a.H = H;
  a.dk = p.dk;
  a.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(p.dk)));
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run<__nv_bfloat16>(p, a, st) : run<float>(p, a, st);
}

extern "C" const char* icaf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
