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
//             tile, head x value slice, batch x direction), 16 query rows a
//             warp. mma.sync m16n8k16 (tiles this small, dk <= 256 and
//             N <= 400, do not fill a wgmma pipeline): S = Q K^T stays in fp32
//             registers with the online softmax in fp32 (exp2 with the
//             scale folded in); P is rounded to bf16 in registers and
//             reused as the A operand of P V, because the accumulator
//             layout of m16n8k16 is its A layout, so P never touches shared
//             memory. K and V tiles of 64 keys arrive by cp.async, double
//             buffered; Q, K and V fragments come from ldmatrix (V through
//             .trans). dk is padded to dkp in {16, 32, 64, 128, 192, 256}
//             (the padding is zero) and ragged N is masked (zero-filled
//             rows, -inf logits). Above 128 the value columns are split
//             across blocks, DV = dkp / 2 each: a 16 x 256 fp32 O
//             accumulator alone would take 128 registers a thread. Each
//             block recomputes S over the full dkp (cheap at N <= 400) and
//             reads its Q fragments from shared memory at every key tile
//             instead of holding them (another 64 registers at 256). K and
//             V tiles of 64 keys then take 136 KB at dkp 256.
//   q/k/v and P are rounded to bf16 before their products, as the JAX
//   einsum path (icafusion_tpu/nn/fusion.py:237-266) and the plain version
//   do.
//
// fp32 (the card's exact comparator, the fp32 Evaluator, cli.val and
// cli.detect): the same two launches on tensor cores, at fp32 accuracy
// through the 3xTF32 split. Each operand x = big + small with big =
// tf32(x) and small = tf32(x - big); a b is taken as small_a big_b +
// big_a small_b + big_a big_b in fp32 accumulators (the small products
// first, as CUTLASS's fast-fp32 path adds them), within a few fp32 ulps of
// the exact product. Bound: operations at 495 / 3 = 165 TFLOP/s, 3.06
// GFLOP a flagship pair (0.074 ms at B = 4); bytes do not bind (16 us).
//   launch 1  projections_tf32_kernel: proj's GEMM grid with fp32 tiles.
//             Thread 0 loads 128 x 32 tiles of X and W (a 128-byte swizzle
//             row holds 32 fp32) by TMA into a 4-stage ring, 48 KB a stage;
//             X rows and W rows are both K-major, the only layout wgmma
//             .tf32 takes. wgmma reads B only from shared memory, so W's
//             small half is written there: the two warpgroups split each
//             arrived W tile where it lies (big in place, small into a twin
//             of the same layout, one elementwise pass over 16 KB). X is
//             A, from registers: each thread reads its fragments (conflict-
//             free 4-byte reads of the swizzled tile) and splits them in
//             registers, which spares shared memory the three products'
//             operand reads; 3 wgmma m64n128k8 a k8 step. The next stage
//             is split and read while the tensor cores run. Their fp32
//             accumulation truncates, which over a 2048-wide row biases the
//             sum past the fp32 gate, so each stage's products start a
//             fresh accumulator whose sum the CUDA cores add to the total,
//             rounding to nearest. No producer warp: a ninth warp would put
//             three on one SM sub-partition and cap every thread at 168
//             registers (the kernel holds 235). Splitting the weights in a
//             pre-pass instead would read 33 MB and write 66 MB a call at
//             the flagship widths, the order of the whole bound at B = 4.
//             The epilogue adds the bias in fp32 and writes q/k/v
//             head-major (6, B, h, N, dkp), 8-byte stores.
//   launch 2  attention_tf32_kernel: the bf16 core's blocks (64 queries, 16
//             a warp; head x value slice; batch x direction) on mma.sync
//             m16n8k8 .tf32, the split made in registers (cvt.rna and a
//             subtraction a value). K and V tiles (64 keys, 32 at dkp 256)
//             by cp.async, double buffered; Q stays in shared memory and is
//             split again at each key tile. The online softmax runs in
//             fp32 registers and the logits never reach device memory. The
//             tf32 accumulator layout (columns 2t, 2t + 1) is not its A
//             layout (columns t, t + 4): both products take k index t as
//             element 2t and t + 4 as 2t + 1 of their 8-wide step, which
//             makes P's accumulator its own A fragment (no shuffle) and each
//             Q or K fragment pair one 8-byte shared-memory read. dk is
//             padded with zeros to dkp in {8, 16, 32, 64, 128, 192, 256};
//             above 128 the value columns are split as in bf16. Shared
//             memory: 24.6 KB at dkp 8 to 204.8 KB at 192 (169 KB at 256).

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
  if (o.dk % 8 == 0) {                      // a 16-byte chunk never
    constexpr int kc = kBN / 8;              // straddles two heads
    for (int v = tid; v < kBM * kc; v += kConsumers) {
      const int r = v / kc, c = (v % kc) * 8;
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

// value columns a block computes: all of dkp up to 128, half above
__host__ __device__ constexpr int value_cols(int dkp) {
  return dkp <= 128 ? dkp : dkp / 2;
}

template <int DKP>
constexpr size_t smem_bytes() {   // Q, K[2] of DKP columns; V[2] of DV
  return (size_t)(3 * 64 * (DKP + 8) + 2 * 64 * (value_cols(DKP) + 8)) * 2;
}

struct Args {
  const __nv_bfloat16* qkv;   // (6, B, H, N, DKP)
  __nv_bfloat16* out[2];      // out_vis, out_ir: (B, N, D)
  int B, N, H, dk;
  float scale_log2;           // log2(e) / sqrt(dk)
};

// grid: (ceil(N / 64), H * DKP / DV, B * 2); blockIdx.y = h * slices +
// value slice; blockIdx.z = b * 2 + direction.
// direction 0: out_vis = softmax(q_ir k_vis^T) v_vis; 1: out_ir, q_vis k_ir v_ir
template <int DKP>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(Args a) {
  constexpr int DV = value_cols(DKP);
  constexpr bool kQInRegs = DKP <= 128;  // else reloaded at each key tile
  constexpr int LD = DKP + 8;            // row pitch (bf16): conflict-free ldmatrix
  constexpr int LDV = DV + 8;
  constexpr int kTileElems = 64 * LD;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sq = smem_u32(smem);
  auto sk = [&](int buf) { return sq + (1 + buf) * kTileElems * 2; };
  auto sv = [&](int buf) {
    return sq + (3 * kTileElems + buf * 64 * LDV) * 2;
  };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int dir = blockIdx.z & 1, b = blockIdx.z >> 1;
  const int h = blockIdx.y / (DKP / DV), c0 = blockIdx.y % (DKP / DV) * DV;
  const int q0 = blockIdx.x * kBQ, N = a.N;
  const int zq = dir == 0 ? 3 : 0, zk = dir == 0 ? 1 : 4, zv = zk + 1;
  auto head = [&](int z) {
    return a.qkv + (((size_t)z * a.B + b) * a.H + h) * (size_t)N * DKP;
  };
  const __nv_bfloat16 *Qg = head(zq), *Kg = head(zk), *Vg = head(zv);

  // rows row0 .. row0 + 63 of a head, `cols` columns from col0, into a
  // tile of row pitch ld; zero past N
  auto load_rows = [&](uint32_t dst, const __nv_bfloat16* src, int row0,
                       int col0, int cols, int ld) {
    const int chunks = cols / 8;         // 16-byte chunks per row
    for (int e = tid; e < 64 * chunks; e += kThreads) {
      const int r = e / chunks, c = e % chunks;
      const bool valid = row0 + r < N;
      cp_async_16(dst + (r * ld + c * 8) * 2,
                  src + (size_t)(valid ? row0 + r : 0) * DKP + col0 + c * 8,
                  valid);
    }
  };
  auto load_kv = [&](int buf, int row0) {
    load_rows(sk(buf), Kg, row0, 0, DKP, LD);
    load_rows(sv(buf), Vg, row0, c0, DV, LDV);
  };

  load_rows(sq, Qg, q0, 0, DKP, LD);
  load_kv(0, 0);
  cp_async_commit();

  // ldmatrix lane offsets: A-style (rows 0-15, k halves) and B-style
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;

  uint32_t qf[kQInRegs ? DKP / 16 : 1][4];
  float o[DV / 8][4];
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  const int tiles = (N + kBKV - 1) / kBKV;
  for (int kt = 0; kt < tiles; ++kt) {
    const int buf = kt & 1, k0 = kt * kBKV;
    if (kt + 1 < tiles) {   // the next tile loads while this one computes
      load_kv(buf ^ 1, k0 + kBKV);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t q_addr = sq + ((warp * 16 + a_row) * LD + a_col) * 2;
    if constexpr (kQInRegs) {
      if (kt == 0) {
#pragma unroll
        for (int kk = 0; kk < DKP / 16; ++kk) ldmatrix_x4(qf[kk], q_addr + kk * 32);
      }
    }

    float s[8][4];   // 16 rows x 64 keys: n-block nb holds keys 8 nb ..
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DKP / 16; ++kk) {
      uint32_t q[4];
      if constexpr (kQInRegs) {
        q[0] = qf[kk][0]; q[1] = qf[kk][1]; q[2] = qf[kk][2]; q[3] = qf[kk][3];
      } else {
        ldmatrix_x4(q, q_addr + kk * 32);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, sk(buf) + ((np * 16 + b_row) * LD + kk * 16 + b_col) * 2);
        mma_bf16_16816(s[2 * np], q, kf[0], kf[1]);
        mma_bf16_16816(s[2 * np + 1], q, kf[2], kf[3]);
      }
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
    for (int i = 0; i < DV / 8; ++i) {
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
      for (int dp = 0; dp < DV / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, sv(buf) + ((kk * 16 + a_row) * LDV + dp * 16 + a_col) * 2);
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
    for (int i = 0; i < DV / 8; ++i) {
      const int d = c0 + 8 * i + 2 * t;
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
  dim3 grid((a.N + kBQ - 1) / kBQ, a.H * (DKP / value_cols(DKP)), a.B * 2);
  flash_attention_kernel<DKP><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace flash

bool g_proj_opt_in[kMaxDevices];

cudaError_t run_bf16(const void* vis, const void* ir,
                     const void* const* w, const void* const* bs, void* qkv,
                     void* out_vis, void* out_ir, int B, int N, int D, int H,
                     int dkp, cudaStream_t st) {
  const int M = B * N, dk = D / H;
  if (dkp < dk || (dkp != 16 && dkp != 32 && dkp != 64 && dkp != 128 &&
                   dkp != 192 && dkp != 256))
    return cudaErrorInvalidValue;
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
    case 128: return flash::launch<128>(a, st);
    case 192: return flash::launch<192>(a, st);
    default: return flash::launch<256>(a, st);
  }
}

// ===========================================================================
// fp32: 3xTF32 tensor-core products (wgmma projections + mma.sync core)
// ===========================================================================

namespace proj32 {

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 4;
constexpr int kTile = kBM * kBK * 4;        // 16 KB, an X tile or a W tile
// A stage: the X tile as TMA writes it, the W tile (its big half once
// split, in place) and W's small half in the same swizzled layout.
constexpr int kStage = 3 * kTile;
// Two warpgroups and no producer warp (a ninth warp caps every thread at
// 168 registers); thread 0 issues the loads.
constexpr int kThreads = 256;
constexpr size_t kSmem = 1024 + kStages * kStage + kStages * 8;
static_assert(kBM == kBN, "one box shape for X and W");
static_assert(kSmem <= 232448, "shared memory");

struct Out {
  const float* b[6];
  float* qkv;   // (6, B, h, N, dkp)
  int M, N, D, H, dk, dkp;
};

__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
projections_tf32_kernel(const __grid_constant__ proj::Maps maps, Out o) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  const uint32_t full = base + kStages * kStage;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int z = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int KT = (o.D + kBK - 1) / kBK;
  const CUtensorMap* xm = &maps.x[z / 3];
  const CUtensorMap* wm = &maps.w[z];

  auto load = [&](int it) {   // thread 0: k tile it into its stage
    const int s = it % kStages;
    mbar_expect_tx(full + 8 * s, 2 * kTile);
    tma_load_2d(base + s * kStage, xm, full + 8 * s, it * kBK, m0);
    tma_load_2d(base + s * kStage + kTile, wm, full + 8 * s, it * kBK, n0);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + 8 * s, 1);
    mbar_init_fence();
    for (int it = 0; it < kStages && it < KT; ++it) load(it);
  }
  __syncthreads();

  // A stage has arrived: split W where it lies (elementwise: its small
  // half sits a tile further on in the same layout), and load this
  // thread's A fragments of X, rows r and r + 8 at columns 8 kk + t and
  // + 4 (chunk c of row r at c ^ (r & 7) under the swizzle: conflict-free),
  // split in registers. A from registers spares shared memory, which the
  // three products' operand reads would otherwise saturate, the reads and
  // writes of X's split.
  const int r = 64 * (warp >> 2) + 16 * (warp & 3) + g;   // r & 7 == g
  auto prepare = [&](int it, uint32_t (&ab)[4][4], uint32_t (&as)[4][4]) {
    const int s = it % kStages;
    mbar_wait(full + 8 * s, (it / kStages) & 1);
    uint4* wt = reinterpret_cast<uint4*>(sbase + s * kStage + kTile);
#pragma unroll
    for (int q = 0; q < kTile / 16 / kThreads; ++q) {
      const int i = tid + q * kThreads;
      const uint4 v = wt[i];
      uint4 big, small;
      split_tf32(__uint_as_float(v.x), big.x, small.x);
      split_tf32(__uint_as_float(v.y), big.y, small.y);
      split_tf32(__uint_as_float(v.z), big.z, small.z);
      split_tf32(__uint_as_float(v.w), big.w, small.w);
      wt[i] = big;
      wt[i + kTile / 16] = small;
    }
    fence_proxy_async();   // these writes are read by wgmma (async proxy)
    const unsigned char* xt = sbase + s * kStage + r * 128 + t * 4;
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)   // (r, t), (r + 8, t), (r, t + 4), (r + 8, t + 4)
        split_tf32(*reinterpret_cast<const float*>(
                       xt + (e & 1) * 1024 + (((2 * kk + (e >> 1)) ^ g) << 4)),
                   ab[kk][e], as[kk][e]);
  };

  // The tensor cores' fp32 accumulation truncates at each product: over
  // the 768 products of a 2048-wide row that biases q/k/v by about 5e-5 of
  // their size, which fails the fp32 gate at dk 160 and 256. So each
  // stage's 12 products start a fresh accumulator, and its sum is added
  // to `total` on the CUDA cores, which round to nearest. The next stage
  // is prepared while the tensor cores run.
  float acc[64], total[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) total[i] = 0.f;
  auto step = [&](int it, const uint32_t (&ab)[4][4],
                  const uint32_t (&as)[4][4], uint32_t (&nb)[4][4],
                  uint32_t (&ns)[4][4]) {
    const uint32_t wb = base + (it % kStages) * kStage + kTile;
    const uint32_t wsm = wb + kTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {   // small products first
      wgmma_m64n128k8_tf32_rs(acc, as[kk], desc_sw128(wb + kk * 32), kk != 0);
      wgmma_m64n128k8_tf32_rs(acc, ab[kk], desc_sw128(wsm + kk * 32), 1);
      wgmma_m64n128k8_tf32_rs(acc, ab[kk], desc_sw128(wb + kk * 32), 1);
    }
    wgmma_commit();
    if (it + 1 < KT) prepare(it + 1, nb, ns);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] += acc[i];
    block_sync();   // stage it is read; W of stage it + 1 is split
    if (tid == 0 && it + kStages < KT) load(it + kStages);
  };
  uint32_t ab0[4][4], as0[4][4], ab1[4][4], as1[4][4];
  prepare(0, ab0, as0);
  block_sync();   // W's halves are shared by both warpgroups
  for (int it = 0; it < KT; it += 2) {   // two A buffers in turn
    step(it, ab0, as0, ab1, as1);
    if (it + 1 < KT) step(it + 1, ab1, as1, ab0, as0);
  }

  // total[4j + 2hf + e]: row 64 wg + 16 (warp % 4) + g + 8 hf, column
  // 8j + 2t + e; written with the bias added, head-major.
  const int B = o.M / o.N;
  const float* bias = o.b[z];
  const size_t head = (size_t)o.N * o.dkp;
  size_t row_off[2];
  bool row_ok[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int m = m0 + r + 8 * hf;
    row_ok[hf] = m < o.M;
    row_off[hf] = ((size_t)z * B + m / o.N) * o.H * head +
                  (size_t)(m % o.N) * o.dkp;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = n0 + 8 * j + 2 * t;
    if (c >= o.D) continue;
    if (o.dk % 2 == 0) {   // c is even: c and c + 1 lie in one head
      const size_t col_off = (size_t)(c / o.dk) * head + c % o.dk;
      const float b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        if (row_ok[hf])
          *reinterpret_cast<float2*>(o.qkv + row_off[hf] + col_off) =
              make_float2(total[4 * j + 2 * hf] + b0,
                          total[4 * j + 2 * hf + 1] + b1);
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (c + e >= o.D) continue;
        const size_t col_off = (size_t)((c + e) / o.dk) * head + (c + e) % o.dk;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          if (row_ok[hf])
            o.qkv[row_off[hf] + col_off] =
                total[4 * j + 2 * hf + e] + bias[c + e];
      }
    }
  }
}

}  // namespace proj32

namespace flash32 {

constexpr int kBQ = 64, kThreads = 128;

// keys a tile: 32 at dkp 256, so that Q and two K and V tiles fit
template <int DKP>
__host__ __device__ constexpr int kv_tile() { return DKP > 192 ? 32 : 64; }
// Row pitches in floats. Q and K fragments are 8-byte reads of rows g at
// column 2t: a pitch of 8 mod 16 puts a half-warp's 16 reads on 32
// distinct banks. V fragments are 4-byte reads of rows 2t and 2t + 1 at
// column g: a pitch of 4 mod 8 does the same for a warp. Rows stay 16-byte
// aligned for cp.async.
template <int DKP>
__host__ __device__ constexpr int ld() { return DKP + (DKP % 16 == 0 ? 8 : 16); }
template <int DKP>
__host__ __device__ constexpr int ldv() { return flash::value_cols(DKP) + 4; }
template <int DKP>
constexpr size_t smem_bytes() {   // Q; K[2]; V[2]
  return (size_t)(kBQ * ld<DKP>() +
                  2 * kv_tile<DKP>() * (ld<DKP>() + ldv<DKP>())) * 4;
}

struct Args {
  const float* qkv;   // (6, B, H, N, DKP)
  float* out[2];      // out_vis, out_ir: (B, N, D)
  int B, N, H, dk;
  float scale_log2;   // log2(e) / sqrt(dk)
};

// grid: (ceil(N / 64), H * DKP / DV, B * 2); blockIdx.y = h * slices +
// value slice; blockIdx.z = b * 2 + direction.
// direction 0: out_vis = softmax(q_ir k_vis^T) v_vis; 1: out_ir, q_vis k_ir v_ir
template <int DKP>
__global__ void __launch_bounds__(kThreads)
attention_tf32_kernel(Args a) {
  constexpr int DV = flash::value_cols(DKP), BKV = kv_tile<DKP>();
  constexpr int LD = ld<DKP>(), LDV = ldv<DKP>();
  extern __shared__ __align__(16) float sf[];
  float* Qs = sf;                        // [64][LD]
  float* Ks = Qs + kBQ * LD;             // [2][BKV][LD]
  float* Vs = Ks + 2 * BKV * LD;         // [2][BKV][LDV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int dir = blockIdx.z & 1, b = blockIdx.z >> 1;
  const int h = blockIdx.y / (DKP / DV), c0 = blockIdx.y % (DKP / DV) * DV;
  const int q0 = blockIdx.x * kBQ, N = a.N;
  const int zq = dir == 0 ? 3 : 0, zk = dir == 0 ? 1 : 4, zv = zk + 1;
  auto head = [&](int z) {
    return a.qkv + (((size_t)z * a.B + b) * a.H + h) * (size_t)N * DKP;
  };
  const float *Qg = head(zq), *Kg = head(zk), *Vg = head(zv);

  // `rows` rows of a head from row0, `cols` columns from col0, into a
  // tile of row pitch ld; zero past N
  auto load_rows = [&](float* dst, const float* src, int row0, int rows,
                       int col0, int cols, int ld) {
    const int chunks = cols / 4;         // 16-byte chunks per row
    for (int e = tid; e < rows * chunks; e += kThreads) {
      const int r = e / chunks, c = e % chunks;
      const bool valid = row0 + r < N;
      cp_async_16(smem_u32(dst + r * ld + c * 4),
                  src + (size_t)(valid ? row0 + r : 0) * DKP + col0 + c * 4,
                  valid);
    }
  };
  auto load_kv = [&](int buf, int row0) {
    load_rows(Ks + buf * BKV * LD, Kg, row0, BKV, 0, DKP, LD);
    load_rows(Vs + buf * BKV * LDV, Vg, row0, BKV, c0, DV, LDV);
  };

  load_rows(Qs, Qg, q0, kBQ, 0, DKP, LD);
  load_kv(0, 0);
  cp_async_commit();

  float o[DV / 8][4];
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const float* qrow = Qs + (warp * 16 + g) * LD + 2 * t;   // and 8 rows on

  const int tiles = (N + BKV - 1) / BKV;
  for (int kt = 0; kt < tiles; ++kt) {
    const int buf = kt & 1, k0 = kt * BKV;
    if (kt + 1 < tiles) {   // the next tile loads while this one computes
      load_kv(buf ^ 1, k0 + BKV);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kb = Ks + buf * BKV * LD;
    const float* Vb = Vs + buf * BKV * LDV;

    // S = Q K^T in DKP / 8 k8 steps. Within a step, k index t stands for
    // column 2t and t + 4 for column 2t + 1, in Q and K alike (a dot
    // product does not depend on the order of its terms), so that each
    // fragment pair is one 8-byte read.
    float s[BKV / 8][4];
#pragma unroll
    for (int nb = 0; nb < BKV / 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DKP / 8; ++kk) {
      const float2 x0 = *reinterpret_cast<const float2*>(qrow + 8 * kk);
      const float2 x1 = *reinterpret_cast<const float2*>(qrow + 8 * LD + 8 * kk);
      uint32_t qb[4], qs[4];
      split_tf32(x0.x, qb[0], qs[0]);
      split_tf32(x1.x, qb[1], qs[1]);
      split_tf32(x0.y, qb[2], qs[2]);
      split_tf32(x1.y, qb[3], qs[3]);
#pragma unroll
      for (int nb = 0; nb < BKV / 8; ++nb) {
        const float2 kv = *reinterpret_cast<const float2*>(
            Kb + (8 * nb + g) * LD + 8 * kk + 2 * t);
        uint32_t kb0, ks0, kb1, ks1;
        split_tf32(kv.x, kb0, ks0);
        split_tf32(kv.y, kb1, ks1);
        mma_3xtf32_1688(s[nb], qb, qs, kb0, kb1, ks0, ks1);
      }
    }

    // online softmax in the log2 domain; rows g (regs 0, 1) and g + 8 (2, 3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < BKV / 8; ++nb)
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
    for (int nb = 0; nb < BKV / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = exp2f(s[nb][e] - m_run[e >> 1]);   // 0 for masked keys
        l_run[e >> 1] += s[nb][e];
      }
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    // O += P V, one k8 step per 8 keys. k index t stands for key 2t and
    // t + 4 for key 2t + 1: P's accumulator (columns 2t, 2t + 1 of rows g
    // and g + 8) is then its A fragment as it lies, with no shuffle, and
    // V's rows are read in that order.
#pragma unroll
    for (int nb = 0; nb < BKV / 8; ++nb) {
      uint32_t pb[4], ps[4];
      split_tf32(s[nb][0], pb[0], ps[0]);   // (g, key 2t)
      split_tf32(s[nb][2], pb[1], ps[1]);   // (g + 8, key 2t)
      split_tf32(s[nb][1], pb[2], ps[2]);   // (g, key 2t + 1)
      split_tf32(s[nb][3], pb[3], ps[3]);   // (g + 8, key 2t + 1)
      const float* v = Vb + (8 * nb + 2 * t) * LDV + g;
#pragma unroll
      for (int i = 0; i < DV / 8; ++i) {
        uint32_t vb0, vs0, vb1, vs1;
        split_tf32(v[8 * i], vb0, vs0);
        split_tf32(v[LDV + 8 * i], vb1, vs1);
        mma_3xtf32_1688(o[i], pb, ps, vb0, vb1, vs0, vs1);
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
    float* dst = a.out[dir] + ((size_t)b * N + q) * D + h * a.dk;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      const int d = c0 + 8 * i + 2 * t;
      const float v0 = o[i][2 * r] * inv, v1 = o[i][2 * r + 1] * inv;
      if (a.dk % 2 == 0) {
        if (d < a.dk) *reinterpret_cast<float2*>(dst + d) = make_float2(v0, v1);
      } else {
        if (d < a.dk) dst[d] = v0;
        if (d + 1 < a.dk) dst[d + 1] = v1;
      }
    }
  }
}

template <int DKP>
cudaError_t launch(const Args& a, cudaStream_t st) {
  static bool opted[kMaxDevices];
  constexpr size_t smem = smem_bytes<DKP>();
  static_assert(smem <= 232448, "shared memory");
  cudaError_t err = opt_in_smem(attention_tf32_kernel<DKP>, smem, opted);
  if (err != cudaSuccess) return err;
  dim3 grid((a.N + kBQ - 1) / kBQ, a.H * (DKP / flash::value_cols(DKP)),
            a.B * 2);
  attention_tf32_kernel<DKP><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace flash32

bool g_proj32_opt_in[kMaxDevices];

cudaError_t run_tf32(const void* vis, const void* ir, const void* const* w,
                     const void* const* bs, void* qkv, void* out_vis,
                     void* out_ir, int B, int N, int D, int H, int dkp,
                     cudaStream_t st) {
  const int M = B * N, dk = D / H;
  if (D % 4 != 0 || dkp < dk ||
      (dkp != 8 && dkp != 16 && dkp != 32 && dkp != 64 && dkp != 128 &&
       dkp != 192 && dkp != 256))
    return cudaErrorInvalidValue;
  proj::Maps maps;
  const cuuint64_t xdims[2] = {(cuuint64_t)D, (cuuint64_t)M};
  const cuuint64_t wdims[2] = {(cuuint64_t)D, (cuuint64_t)D};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 4};
  const cuuint32_t box[2] = {proj32::kBK, proj32::kBM};
  const void* xs[2] = {vis, ir};
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 2 && err == cudaSuccess; ++i)
    err = encode_f32_map(&maps.x[i], xs[i], 2, xdims, strides, box);
  for (int i = 0; i < 6 && err == cudaSuccess; ++i)
    err = encode_f32_map(&maps.w[i], w[i], 2, wdims, strides, box);
  if (err != cudaSuccess) return err;
  err = opt_in_smem(proj32::projections_tf32_kernel, proj32::kSmem,
                    g_proj32_opt_in);
  if (err != cudaSuccess) return err;
  proj32::Out o;
  for (int i = 0; i < 6; ++i) o.b[i] = static_cast<const float*>(bs[i]);
  o.qkv = static_cast<float*>(qkv);
  o.M = M;
  o.N = N;
  o.D = D;
  o.H = H;
  o.dk = dk;
  o.dkp = dkp;
  dim3 grid((D + proj32::kBN - 1) / proj32::kBN,
            (M + proj32::kBM - 1) / proj32::kBM, 6);
  proj32::projections_tf32_kernel<<<grid, proj32::kThreads, proj32::kSmem,
                                    st>>>(maps, o);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  flash32::Args a;
  a.qkv = o.qkv;
  a.out[0] = static_cast<float*>(out_vis);
  a.out[1] = static_cast<float*>(out_ir);
  a.B = B;
  a.N = N;
  a.H = H;
  a.dk = dk;
  a.scale_log2 = static_cast<float>(1.4426950408889634 /
                                    std::sqrt(static_cast<double>(dk)));
  switch (dkp) {
    case 8: return flash32::launch<8>(a, st);
    case 16: return flash32::launch<16>(a, st);
    case 32: return flash32::launch<32>(a, st);
    case 64: return flash32::launch<64>(a, st);
    case 128: return flash32::launch<128>(a, st);
    case 192: return flash32::launch<192>(a, st);
    default: return flash32::launch<256>(a, st);
  }
}

}  // namespace

// weights / biases: host arrays of six device pointers each, in the order
// q_vis k_vis v_vis q_ir k_ir v_ir. qkv: a scratch of (6, B, H, N, dkp) in
// the tokens' dtype, dkp at least dk and the padding zeroed (the caller
// picks it: F32_DK_PADS and BF16_DK_PADS in kernels/cross_attention.py;
// fp32 takes 8, 16, 32, 64, 128, 192 or 256, bf16 the same but 8).
// dk <= 256. TMA reads the tokens and weights: D % 8 == 0 in bf16, D % 4 ==
// 0 in fp32 (rows of 16-byte multiples), every token and weight pointer
// 16-byte aligned.
extern "C" int icaf_dual_cross_attention(
    const void* vis, const void* ir, const void* weights, const void* biases,
    void* qkv, void* out_vis, void* out_ir, int B, int N, int D, int H,
    int dkp, int is_bf16, void* stream) {
  if (B == 0 || N == 0) return cudaSuccess;
  const void* const* w = static_cast<const void* const*>(weights);
  const void* const* bs = static_cast<const void* const*>(biases);
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return run_bf16(vis, ir, w, bs, qkv, out_vis, out_ir, B, N, D, H, dkp, st);
  return run_tf32(vis, ir, w, bs, qkv, out_vis, out_ir, B, N, D, H, dkp, st);
}

extern "C" const char* icaf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
