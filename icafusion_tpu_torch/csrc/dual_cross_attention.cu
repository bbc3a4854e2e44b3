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
// tensor cores' rate: about 12 us in all at 989 TFLOP/s bf16. Both dtypes
// run two launches; both cover both directions, and the N x N logits never
// reach device memory.
//
// bf16 (the serving path), on tensor cores:
//   launch 1  projections_wgmma_kernel: the six projections as one GEMM
//             grid, z-slice = projection. X (B*N, D) and W (D, D) in torch
//             Linear layout are both K-major, which is what wgmma takes for
//             A and B, so nothing is transposed. A producer warp streams
//             128 x 64 tiles of X and W by TMA (128-byte swizzle, zero fill
//             past the edges) into a 3-stage ring guarded by full/empty
//             mbarriers; two warpgroups each run wgmma m64n128k16 on their
//             64 rows. The epilogue rounds the product to bf16, adds the
//             bias rounded to bf16 and rounds the sum (the plain version's
//             rounding points), stages the 128 x 128 tile in shared memory
//             and writes q/k/v head-major (6, B, h, N, dkp) with 16-byte
//             stores along each head's rows. bf16 x bf16 products are exact
//             in fp32, so only the order of the sums differs from an fp32
//             GEMM.
//   launch 2  flash_attention_kernel: one block of 4 warps per (64-query
//             tile, head, batch x direction), 16 query rows a warp.
//             mma.sync m16n8k16 (tiles this small, dk <= 128 and N <= 400,
//             do not fill a wgmma pipeline): S = Q K^T stays in fp32
//             registers with the online softmax in fp32 (exp2 with the
//             scale folded in); P is rounded to bf16 in registers and
//             reused as the A operand of P V, because the accumulator
//             layout of m16n8k16 is its A layout, so P never touches shared
//             memory. K and V tiles of 64 keys arrive by cp.async, double
//             buffered; Q, K and V fragments come from ldmatrix (V through
//             .trans). dk is padded to dkp in {16, 32, 64, 128} (the padding
//             is zero) and ragged N is masked (zero-filled rows, -inf
//             logits).
//   q/k/v and P are rounded to bf16 before their products, as the JAX
//   einsum path (icafusion_tpu/nn/fusion.py:237-266) and the plain version
//   do.
//
// fp32 (the card's exact comparator, the fp32 Evaluator): CUDA cores, no
// TF32, the first design:
//   launch 1  a tiled shared-memory GEMM (64 x 64 tiles, 4 x 4 outputs per
//             thread), one grid z-slice per projection, into an fp32 scratch
//             (6, B, h, N, dk);
//   launch 2  one block per (64-query tile, head, batch x direction) runs an
//             online softmax over 64-key tiles of K and V staged in shared
//             memory; four threads share a query row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>

#include "hopper.cuh"

namespace {

using namespace hopper;

// ===========================================================================
// bf16: wgmma projections + mma.sync flash attention
// ===========================================================================

namespace proj {

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 3;
constexpr int kTile = kBM * kBK * 2;        // 16 KB, an X tile or a W tile
constexpr int kStage = 2 * kTile;
constexpr int kThreads = 288;               // warpgroups 0 and 1, warp 8 loads
constexpr int kConsumers = 256;
constexpr int kLDO = kBN + 8;               // epilogue staging row (bf16)
constexpr size_t kSmem = 1024 + kStages * kStage + 2 * kStages * 8;
static_assert(kBM == kBN, "one box shape for X and W");
static_assert(kBM * kLDO * 2 <= kStages * kStage, "staging fits the ring");

struct Maps {
  CUtensorMap x[2];   // vis, ir as (B*N, D)
  CUtensorMap w[6];   // (D, D)
};

struct Out {
  const float* b[6];
  __nv_bfloat16* qkv;   // (6, B, h, N, dkp)
  int M, N, D, H, dk, dkp;
};

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

__global__ void __launch_bounds__(kThreads, 2)
projections_wgmma_kernel(const __grid_constant__ Maps maps, Out o) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  const uint32_t full = base + kStages * kStage, empty = full + 8 * kStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int z = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int KT = (o.D + kBK - 1) / kBK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);   // one arrival per warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {   // producer
    if (lane == 0) {
      const CUtensorMap* xm = &maps.x[z / 3];
      const CUtensorMap* wm = &maps.w[z];
      for (int it = 0; it < KT; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty + 8 * s, ((it / kStages) - 1) & 1);
        mbar_expect_tx(full + 8 * s, kStage);
        tma_load_2d(base + s * kStage, xm, full + 8 * s, it * kBK, m0);
        tma_load_2d(base + s * kStage + kTile, wm, full + 8 * s, it * kBK, n0);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  float acc[64];
  for (int it = 0; it < KT; ++it) {
    const int s = it % kStages;
    mbar_wait(full + 8 * s, (it / kStages) & 1);
    __syncwarp();
    const uint32_t a = base + s * kStage + wg * 64 * 128, b = base + s * kStage + kTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_m64n128k16_ss(acc, desc_sw128(a + kk * 32), desc_sw128(b + kk * 32),
                          (it | kk) != 0);
    wgmma_commit();
    wgmma_wait<1>();   // the previous stage's products are done: release it
    if (it > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % kStages));
  }
  wgmma_wait<0>();
  consumer_sync();   // both warpgroups are done with the ring

  // acc[4j + 2hf + e]: row 16 (warp % 4) + g + 8 hf, column 8j + 2t + e.
  // The product and the bias are each rounded to bf16 and their sum rounded
  // again, where x @ w.t() + b rounds in bf16 (the plain version, the JAX
  // einsum path): q and k differences of one ulp move the logits by their
  // magnitude times 2^-8, so the kernel rounds where they do.
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(sbase);
  const int g = lane >> 2, t = lane & 3;
  const float* bias = o.b[z];
  auto bf16r = [](float v) { return __bfloat162float(__float2bfloat16(v)); };
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * t;
    const float b0 = n0 + c < o.D ? bf16r(bias[n0 + c]) : 0.f;
    const float b1 = n0 + c + 1 < o.D ? bf16r(bias[n0 + c + 1]) : 0.f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wg * 64 + (warp & 3) * 16 + g + 8 * hf;
      *reinterpret_cast<uint32_t*>(st + r * kLDO + c) =
          pack_bf16(bf16r(acc[4 * j + 2 * hf]) + b0,
                    bf16r(acc[4 * j + 2 * hf + 1]) + b1);
    }
  }
  consumer_sync();

  const int B = o.M / o.N;
  auto dst = [&](int m, int col) {   // (b, n) = divmod(m, N), (h, d) = divmod(col, dk)
    return o.qkv + ((((size_t)z * B + m / o.N) * o.H + col / o.dk) * o.N +
                    m % o.N) * o.dkp + col % o.dk;
  };
  if (o.dk % 8 == 0 && kBN % o.dk == 0) {   // 16 bytes along a head's rows
    const int kc = o.dk / 8;
    for (int v = tid; v < kBM * kBN / 8; v += kConsumers) {
      const int hh = v / (kBM * kc), rem = v % (kBM * kc);
      const int r = rem / kc, c = hh * o.dk + (rem % kc) * 8;
      if (m0 + r < o.M && n0 + c < o.D)
        *reinterpret_cast<uint4*>(dst(m0 + r, n0 + c)) =
            *reinterpret_cast<const uint4*>(st + r * kLDO + c);
    }
  } else {                                  // any dk: one element a thread
    for (int v = tid; v < kBM * kBN; v += kConsumers) {
      const int r = v / kBN, c = v % kBN;
      if (m0 + r < o.M && n0 + c < o.D) *dst(m0 + r, n0 + c) = st[r * kLDO + c];
    }
  }
}

}  // namespace proj

namespace flash {

constexpr int kBQ = 64, kBKV = 64, kThreads = 128;

template <int DKP>
constexpr size_t smem_bytes() {
  return (size_t)5 * 64 * (DKP + 8) * 2;   // Q, K[2], V[2]
}

struct Args {
  const __nv_bfloat16* qkv;   // (6, B, H, N, DKP)
  __nv_bfloat16* out[2];      // out_vis, out_ir: (B, N, D)
  int B, N, H, dk;
  float scale_log2;           // log2(e) / sqrt(dk)
};

// grid: (ceil(N / 64), H, B * 2); blockIdx.z = b * 2 + direction.
// direction 0: out_vis = softmax(q_ir k_vis^T) v_vis; 1: out_ir, q_vis k_ir v_ir
template <int DKP>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(Args a) {
  constexpr int LD = DKP + 8;            // row pitch (bf16): conflict-free ldmatrix
  constexpr int kTileElems = 64 * LD;
  constexpr int kChunks = DKP / 8;       // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sq = smem_u32(smem);
  auto sk = [&](int buf) { return sq + (1 + buf) * kTileElems * 2; };
  auto sv = [&](int buf) { return sq + (3 + buf) * kTileElems * 2; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int dir = blockIdx.z & 1, b = blockIdx.z >> 1, h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ, N = a.N;
  const int zq = dir == 0 ? 3 : 0, zk = dir == 0 ? 1 : 4, zv = zk + 1;
  auto head = [&](int z) {
    return a.qkv + (((size_t)z * a.B + b) * a.H + h) * (size_t)N * DKP;
  };
  const __nv_bfloat16 *Qg = head(zq), *Kg = head(zk), *Vg = head(zv);

  // rows row0 .. row0 + 63 of a head into a tile, zero past N
  auto load_rows = [&](uint32_t dst, const __nv_bfloat16* src, int row0) {
    for (int e = tid; e < 64 * kChunks; e += kThreads) {
      const int r = e / kChunks, c = e % kChunks;
      const bool valid = row0 + r < N;
      cp_async_16(dst + (r * LD + c * 8) * 2,
                  src + (size_t)(valid ? row0 + r : 0) * DKP + c * 8, valid);
    }
  };

  load_rows(sq, Qg, q0);
  load_rows(sk(0), Kg, 0);
  load_rows(sv(0), Vg, 0);
  cp_async_commit();

  // ldmatrix lane offsets: A-style (rows 0-15, k halves) and B-style
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;

  uint32_t qf[DKP / 16][4];
  float o[DKP / 8][4];
#pragma unroll
  for (int i = 0; i < DKP / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  const int tiles = (N + kBKV - 1) / kBKV;
  for (int kt = 0; kt < tiles; ++kt) {
    const int buf = kt & 1, k0 = kt * kBKV;
    if (kt + 1 < tiles) {   // the next tile loads while this one computes
      load_rows(sk(buf ^ 1), Kg, k0 + kBKV);
      load_rows(sv(buf ^ 1), Vg, k0 + kBKV);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < DKP / 16; ++kk)
        ldmatrix_x4(qf[kk], sq + ((warp * 16 + a_row) * LD + kk * 16 + a_col) * 2);
    }

    float s[8][4];   // 16 rows x 64 keys: n-block nb holds keys 8 nb ..
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DKP / 16; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, sk(buf) + ((np * 16 + b_row) * LD + kk * 16 + b_col) * 2);
        mma_bf16_16816(s[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16_16816(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }

    // online softmax in the log2 domain; rows g (regs 0, 1) and g + 8 (2, 3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = k0 + 8 * nb + 2 * t + (e & 1) < N;
        s[nb][e] = valid ? s[nb][e] * a.scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);   // finite: key k0 is valid
      alpha[r] = exp2f(m_run[r] - m_new);           // 0 on the first tile
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = exp2f(s[nb][e] - m_run[e >> 1]);   // 0 for masked keys
        l_run[e >> 1] += s[nb][e];
      }
#pragma unroll
    for (int i = 0; i < DKP / 8; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    // O += P V: P's accumulator layout is the A fragment of 16 keys
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DKP / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, sv(buf) + ((kk * 16 + a_row) * LD + dp * 16 + a_col) * 2);
        mma_bf16_16816(o[2 * dp], pa, vf[0], vf[1]);
        mma_bf16_16816(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();   // every warp is done with buf before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const int D = a.H * a.dk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = q0 + warp * 16 + g + 8 * r;
    if (q >= N) continue;
    const float inv = 1.f / l_run[r];
    __nv_bfloat16* dst = a.out[dir] + ((size_t)b * N + q) * D + h * a.dk;
#pragma unroll
    for (int i = 0; i < DKP / 8; ++i) {
      const int d = 8 * i + 2 * t;
      const float v0 = o[i][2 * r] * inv, v1 = o[i][2 * r + 1] * inv;
      if (a.dk % 2 == 0) {
        if (d < a.dk)
          *reinterpret_cast<__nv_bfloat162*>(dst + d) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (d < a.dk) dst[d] = __float2bfloat16(v0);
        if (d + 1 < a.dk) dst[d + 1] = __float2bfloat16(v1);
      }
    }
  }
}

template <int DKP>
cudaError_t launch(const Args& a, cudaStream_t st) {
  static bool opted[kMaxDevices];
  constexpr size_t smem = smem_bytes<DKP>();
  cudaError_t err = opt_in_smem(flash_attention_kernel<DKP>, smem, opted);
  if (err != cudaSuccess) return err;
  dim3 grid((a.N + kBQ - 1) / kBQ, a.H, a.B * 2);
  flash_attention_kernel<DKP><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace flash

// dk padded to the width the flash kernel is built for
int padded_dk(int dk) { return dk <= 16 ? 16 : dk <= 32 ? 32 : dk <= 64 ? 64 : 128; }

bool g_proj_opt_in[kMaxDevices];

cudaError_t run_bf16(const void* vis, const void* ir,
                     const void* const* w, const void* const* bs, void* qkv,
                     void* out_vis, void* out_ir, int B, int N, int D, int H,
                     cudaStream_t st) {
  const int M = B * N, dk = D / H, dkp = padded_dk(dk);
  proj::Maps maps;
  const cuuint64_t xdims[2] = {(cuuint64_t)D, (cuuint64_t)M};
  const cuuint64_t wdims[2] = {(cuuint64_t)D, (cuuint64_t)D};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {proj::kBK, proj::kBM};
  const void* xs[2] = {vis, ir};
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 2 && err == cudaSuccess; ++i)
    err = encode_bf16_map(&maps.x[i], xs[i], 2, xdims, strides, box);
  for (int i = 0; i < 6 && err == cudaSuccess; ++i)
    err = encode_bf16_map(&maps.w[i], w[i], 2, wdims, strides, box);
  if (err != cudaSuccess) return err;
  err = opt_in_smem(proj::projections_wgmma_kernel, proj::kSmem, g_proj_opt_in);
  if (err != cudaSuccess) return err;
  proj::Out o;
  for (int i = 0; i < 6; ++i) o.b[i] = static_cast<const float*>(bs[i]);
  o.qkv = static_cast<__nv_bfloat16*>(qkv);
  o.M = M;
  o.N = N;
  o.D = D;
  o.H = H;
  o.dk = dk;
  o.dkp = dkp;
  dim3 grid((D + proj::kBN - 1) / proj::kBN, (M + proj::kBM - 1) / proj::kBM, 6);
  proj::projections_wgmma_kernel<<<grid, proj::kThreads, proj::kSmem, st>>>(
      maps, o);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  flash::Args a;
  a.qkv = o.qkv;
  a.out[0] = static_cast<__nv_bfloat16*>(out_vis);
  a.out[1] = static_cast<__nv_bfloat16*>(out_ir);
  a.B = B;
  a.N = N;
  a.H = H;
  a.dk = dk;
  a.scale_log2 = static_cast<float>(1.4426950408889634 /
                                    std::sqrt(static_cast<double>(dk)));
  switch (dkp) {
    case 16: return flash::launch<16>(a, st);
    case 32: return flash::launch<32>(a, st);
    case 64: return flash::launch<64>(a, st);
    default: return flash::launch<128>(a, st);
  }
}

// ===========================================================================
// fp32: CUDA cores (the first design)
// ===========================================================================

struct ProjArgs {
  const float* x[2];     // vis, ir: (B*N, D)
  const float* w[6];     // (D, D) torch Linear layout (out, in)
  const float* b[6];     // (D,)
  float* qkv;            // (6, B, H, N, dk)
  int M, N, D, H, dk;    // M = B * N
};

constexpr int kBM = 64, kBN = 64, kBK = 16, kProjThreads = 256;

// out[z][row][col] = sum_k X[row][k] * W_z[col][k] + b_z[col], scattered to
// the per-head layout. z = 0..5 in the order q_vis k_vis v_vis q_ir k_ir v_ir.
__global__ void __launch_bounds__(kProjThreads)
projections_f32_kernel(ProjArgs a) {
  const int z = blockIdx.z;
  const float* __restrict__ X = a.x[z / 3];
  const float* __restrict__ W = a.w[z];
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
      As[lk + e][lrow] = (gm < a.M && k < a.D) ? X[(size_t)gm * a.D + k] : 0.f;
      Bs[lk + e][lrow] = (gn < a.D && k < a.D) ? W[(size_t)gn * a.D + k] : 0.f;
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
  float* out[2];         // out_vis, out_ir: (B, N, D)
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
template <int DKP>
__global__ void __launch_bounds__(kAttnThreads)
attention_f32_kernel(AttnArgs a) {
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
  float* out = a.out[dir] + ((size_t)b * N + q) * (a.H * dk) + h * dk;
  const float inv = 1.f / l;
#pragma unroll
  for (int dd = 0; dd < DPT; ++dd) {
    const int d = sub + 4 * dd;
    if (d < dk) out[d] = acc[dd] * inv;
  }
}

template <int DKP>
cudaError_t launch_attention_f32(const AttnArgs& a, cudaStream_t stream) {
  constexpr int smem = attn_smem_floats<DKP>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attention_f32_kernel<DKP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.N + kBQ - 1) / kBQ, a.H, a.B * 2);
  attention_f32_kernel<DKP><<<grid, kAttnThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t run_f32(const void* vis, const void* ir, const void* const* w,
                    const void* const* bs, void* qkv, void* out_vis,
                    void* out_ir, int B, int N, int D, int H,
                    cudaStream_t st) {
  ProjArgs p;
  p.x[0] = static_cast<const float*>(vis);
  p.x[1] = static_cast<const float*>(ir);
  for (int i = 0; i < 6; ++i) {
    p.w[i] = static_cast<const float*>(w[i]);
    p.b[i] = static_cast<const float*>(bs[i]);
  }
  p.qkv = static_cast<float*>(qkv);
  p.M = B * N;
  p.N = N;
  p.D = D;
  p.H = H;
  p.dk = D / H;
  dim3 grid((p.M + kBM - 1) / kBM, (p.D + kBN - 1) / kBN, 6);
  projections_f32_kernel<<<grid, kProjThreads, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  AttnArgs a;
  a.qkv = p.qkv;
  a.out[0] = static_cast<float*>(out_vis);
  a.out[1] = static_cast<float*>(out_ir);
  a.B = B;
  a.N = N;
  a.H = H;
  a.dk = p.dk;
  a.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(p.dk)));
  if (a.dk <= 32) return launch_attention_f32<32>(a, st);
  if (a.dk <= 64) return launch_attention_f32<64>(a, st);
  if (a.dk <= 128) return launch_attention_f32<128>(a, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// weights / biases: host arrays of six device pointers each, in the order
// q_vis k_vis v_vis q_ir k_ir v_ir. qkv: a scratch of (6, B, H, N, dk) fp32
// for fp32, or (6, B, H, N, dkp) bf16 for bf16 with dkp = dk rounded up to
// 16, 32, 64 or 128 and the padding zeroed. bf16 needs D % 8 == 0 and every
// token and weight pointer 16-byte aligned (TMA).
extern "C" int icaf_dual_cross_attention(
    const void* vis, const void* ir, const void* weights, const void* biases,
    void* qkv, void* out_vis, void* out_ir, int B, int N, int D, int H,
    int is_bf16, void* stream) {
  if (B == 0 || N == 0) return cudaSuccess;
  const void* const* w = static_cast<const void* const*>(weights);
  const void* const* bs = static_cast<const void* const*>(biases);
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run_bf16(vis, ir, w, bs, qkv, out_vis, out_ir, B, N, D, H, st)
                 : run_f32(vis, ir, w, bs, qkv, out_vis, out_ir, B, N, D, H, st);
}

extern "C" const char* icaf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
