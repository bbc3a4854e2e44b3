// Greedy NMS as a suppression bitmask built across the card and a one-warp
// scan of it, one block per image.
//
// Replaces the Pallas TPU kernel icafusion_tpu/kernels/nms.py:
// pallas_greedy_nms (body _nms_kernel). Its semantics: max_det steps, each
// picking the highest active score (ties to the lowest index), then setting
// the pick and every candidate whose IoU with it exceeds iou_thres to -1;
// keep[step] is the pick, ok[step] is (picked score > 0).
//
// Contract: scores are finite and non-increasing along K. Let live be the
// number of scores > -1 and pos the number > 0; both are prefixes. Then a
// step's argmax is the first candidate j not yet removed, if j < live.
// Otherwise every active score is -1 or less, the argmax is index 0 (picked
// at step 0, or padding), and picking it again changes nothing. So keep
// holds the picks of a walk in index order over [0, live), then zeros, and
// ok[step] = (pick < pos). On unsorted scores the kernels do not reproduce
// the argmax loop.
//
// What bounds it on the H100: not bytes (K = 1024 boxes are 16 KB an image)
// nor operations as such, but (1) the serial chain of up to max_det steps,
// each needing the suppression of the step before, and (2) the K^2/2 IoUs
// the chain would otherwise compute in its steps. The design takes (2) off
// the chain and keeps (1) short:
//
// A. nms_mask_kernel, a grid over the (column tile, row tile) pairs on or
//    above the diagonal, times the images: bit j of row i's word j / 64 is
//    set iff j > i and IoU(i, j) > iou_thres. A block stages its 64 column
//    boxes in shared memory and gives each row one thread, or four on a
//    grid too small to fill the card (K = 1024: 136 tiles an image), so
//    that the loop a thread runs is short. Words left of a row's diagonal
//    tile are never written and never read; nor is a tile whose first
//    column is not live (scores descend, so none of its columns is).
// B. nms_scan_kernel, one block per image. Warp 0 walks word by word: the
//    removed set of a window of 32 words (2048 candidates) sits in its
//    lanes' registers, a word a lane. Inside a word the picks are a chain
//    on a value all lanes hold alike: a find-first-set and one
//    shared-memory load of the pick's row word; the same step ORs each
//    lane's own word of that row in, off the chain. Words past the window
//    gather their bits in shared memory and enter the registers when the
//    window moves on. Warp 1 streams the mask rows ahead of the walk into
//    a ring in shared memory with bulk asynchronous copies (cp.async.bulk
//    on mbarriers); the walk only moves forward, so the stream never
//    guesses, and chunks that lie wholly behind the walk are skipped. At
//    K = 1024 the whole image's mask (128 KB) fits in the ring, and up to
//    2048 live candidates a word's rows are held at once, so the chain has
//    no branch but its loop. Nothing in the walk depends on K beyond the
//    word count.
//
// The mask scratch is (B, K, Wp) 64-bit words, Wp = ceil(K / 64) rounded up
// to even (16-byte rows for the bulk copies): B * K * Wp * 8 bytes, 0.5 MB at
// K = 1024, B = 4 and about 200 MB at K = 20000, B = 4. The ring must hold
// one row, which bounds K at about 900,000, where the scratch alone is over
// 100 GB an image.
//
// The IoU arithmetic uses __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn, which
// the compiler never contracts into fused multiply-adds, in the operation
// order of kernels/nms.py:50-55; IoU(i, j) equals IoU(j, i) bit for bit, so
// a candidate exactly at the threshold falls as in the plain loop.

#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kTile = 64;             // candidates a mask word covers
// Up to this many tiles (about a wave of 64-thread blocks on 132 SMs) the
// mask kernel gives a row four threads.
constexpr long long kSmallGrid = 4096;
constexpr int kScanThreads = 128;     // warp 0 walks, warp 1 streams
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kChunkBytes = 16 << 10; // rows of one bulk copy, at least one
constexpr int kRingBytes = 128 << 10;
constexpr int kMaxStages = 8;
// a block's shared memory on sm_90, less room for the static arrays
constexpr int kMaxSmem = 232448 - 1024;

__device__ __forceinline__ float area_rn(float x1, float y1, float x2,
                                         float y2) {
  return __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
}

// G threads a row, each taking every G-th column of the tile.
template <int G>
__global__ void __launch_bounds__(kTile * G)
nms_mask_kernel(const float* __restrict__ boxes,   // (B, K, 4)
                const float* __restrict__ scores,  // (B, K)
                uint64_t* __restrict__ mask,       // (B, K, Wp)
                int K, int Wp, float iou_thres) {
  // tile t of the upper triangle, column by column:
  // ct (ct + 1) / 2 <= t < (ct + 1) (ct + 2) / 2, rt = the rest
  const long long t = blockIdx.x;
  int ct = static_cast<int>((sqrtf(8.f * static_cast<float>(t) + 1.f) - 1.f) *
                            0.5f);
  while (static_cast<long long>(ct + 1) * (ct + 2) / 2 <= t) ++ct;
  while (static_cast<long long>(ct) * (ct + 1) / 2 > t) --ct;
  const int rt = static_cast<int>(t - static_cast<long long>(ct) * (ct + 1) / 2);
  const int b = blockIdx.y, tid = threadIdx.x;
  const int r = tid / G, g = tid % G;    // row of the tile, column group
  const int c0 = ct * kTile, i = rt * kTile + r;
  const float* bx = boxes + static_cast<size_t>(b) * K * 4;
  // the walk reads only live rows and words (rt <= ct)
  if (!(scores[static_cast<size_t>(b) * K + c0] > -1.f)) return;

  __shared__ float4 s_box[kTile];
  __shared__ float s_area[kTile];
  if (tid < kTile) {
    const int j = c0 + tid;
    float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < K) c = make_float4(bx[j * 4], bx[j * 4 + 1], bx[j * 4 + 2],
                               bx[j * 4 + 3]);
    s_box[tid] = c;
    s_area[tid] = area_rn(c.x, c.y, c.z, c.w);
  }
  float x1 = 0.f, y1 = 0.f, x2 = 0.f, y2 = 0.f;
  if (i < K) {
    x1 = bx[i * 4];
    y1 = bx[i * 4 + 1];
    x2 = bx[i * 4 + 2];
    y2 = bx[i * 4 + 3];
  }
  const float area = area_rn(x1, y1, x2, y2);
  __syncthreads();

  // An empty intersection gives IoU +-0 or NaN, above no threshold >= 0:
  // the division runs only where it can set a bit.
  const bool any_pair = iou_thres < 0.f;
  uint64_t bits = 0;
#pragma unroll 8
  for (int k = 0; k < kTile / G; ++k) {
    const int c = k * G + g;
    const float4 p = s_box[c];
    const float iw = fmaxf(__fsub_rn(fminf(p.z, x2), fmaxf(p.x, x1)), 0.f);
    const float ih = fmaxf(__fsub_rn(fminf(p.w, y2), fmaxf(p.y, y1)), 0.f);
    const float inter = __fmul_rn(iw, ih);
    if (inter > 0.f || any_pair) {
      const float den =
          __fadd_rn(__fsub_rn(__fadd_rn(s_area[c], area), inter), 1e-12f);
      if (__fdiv_rn(inter, den) > iou_thres) bits |= 1ull << c;
    }
  }
#pragma unroll
  for (int off = 1; off < G; off <<= 1)   // the row's groups, neighbours
    bits |= __shfl_xor_sync(~0u, bits, off);
  if (g != 0 || i >= K) return;
  if (K - c0 < kTile) bits &= (1ull << (K - c0)) - 1;          // past K
  if (rt == ct) bits &= r == kTile - 1 ? 0ull : ~0ull << (r + 1);  // j > i
  mask[(static_cast<size_t>(b) * K + i) * Wp + ct] = bits;
}

__device__ __forceinline__ int block_sum(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(~0u, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < kScanWarps; ++w) s += red[w];
  return s;
}

// Dynamic shared memory: the ring (stages x rows x Wp words), the far
// words (Wp), the full and empty barriers (stages each) and the chunk each
// stage holds (stages ints).
__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const float* __restrict__ scores,   // (B, K)
                const uint64_t* __restrict__ mask,  // (B, K, Wp)
                int* __restrict__ keep,             // (B, max_det)
                bool* __restrict__ ok,              // (B, max_det)
                int K, int Wp, int max_det, int rows, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t stage_words = static_cast<size_t>(rows) * Wp;
  uint64_t* ring = reinterpret_cast<uint64_t*>(smem);
  uint64_t* far = ring + stages * stage_words;
  const uint32_t full = smem_u32(far + Wp), empty = full + 8 * stages;
  int* chunk_of = reinterpret_cast<int*>(far + Wp + 2 * stages);
  __shared__ int s_red[2][kScanWarps];
  __shared__ int s_cursor, s_done;   // walk -> stream: the next row it needs
  volatile int* cursor = &s_cursor;
  volatile int* done = &s_done;

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* sc = scores + static_cast<size_t>(b) * K;
  const uint64_t* gmask = mask + static_cast<size_t>(b) * K * Wp;
  const uint32_t row_bytes = static_cast<uint32_t>(Wp) * 8;

  // load n of the stream goes to stage n % stages; chunk c is rows
  // [c * rows, (c + 1) * rows)
  auto load_chunk = [&](int n, int c) {
    const int s = n % stages;
    chunk_of[s] = c;
    const uint32_t bytes = min(rows, K - c * rows) * row_bytes;
    mbar_expect_tx(full + 8 * s, bytes);
    bulk_load(smem_u32(ring + s * stage_words),
              gmask + static_cast<size_t>(c) * rows * Wp, bytes, full + 8 * s);
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);
    }
    mbar_init_fence();
    s_cursor = 0;
    s_done = 0;
  }
  __syncthreads();
  if (tid == 32) load_chunk(0, 0);   // its bytes do not depend on live
  int n_live = 0, n_pos = 0;
#pragma unroll 8
  for (int j = tid; j < K; j += kScanThreads) {
    const float s = sc[j];
    n_live += s > -1.f;
    n_pos += s > 0.f;
  }
  for (int w = tid; w < Wp; w += kScanThreads) far[w] = 0;
  const int live = block_sum(n_live, s_red[0]);
  const int pos = block_sum(n_pos, s_red[1]);
  const int live_words = (live + kTile - 1) / kTile;

  if (warp == 1) {   // the stream
    if (lane != 0) return;
    const int n_chunks = (live + rows - 1) / rows;
    int n = 1;
    for (int c = 1; c < n_chunks && !*done; ++c) {
      if ((c + 1) * rows <= *cursor) continue;   // wholly behind the walk
      const int s = n % stages;
      if (n >= stages) {   // stage s's last load released by the walk
        const uint32_t parity = ((n / stages) - 1) & 1;
        bool released = false;
        while (!(released = mbar_try_wait(empty + 8 * s, parity)) && !*done) {
        }
        if (!released) break;
      }
      load_chunk(n++, c);
    }
    // no copy may land in this block's shared memory after it exits
    for (int m = max(0, n - stages); m < n; ++m)
      mbar_wait(full + 8 * (m % stages), (m / stages) & 1);
    return;
  }
  if (warp != 0) return;

  // The walk. Lane l holds word base + l of the removed set (bits past
  // live set); far[] gathers the words past that window, each always by the
  // lane of its index mod 32.
  auto window = [&](int base) -> uint64_t {
    const int w = base + lane;
    if (w >= live_words) return ~0ull;
    uint64_t v = far[w];
    const int tail = live - w * kTile;
    if (tail < kTile) v |= ~0ull << tail;
    return v;
  };
  int* kp = keep + static_cast<size_t>(b) * max_det;
  bool* okp = ok + static_cast<size_t>(b) * max_det;
  int base = 0, step = 0;
  uint64_t removed = window(0);
  int m = 0, held = -1;            // load m of the stream, held if >= 0
  int held_lo = 0, held_hi = 0;    // its rows
  int stage_at = 0;                // its first word in the ring
  auto acquire = [&](int j) {      // hold the load with row j
    const int c = j / rows;
    while (held != c) {
      if (held >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * (m % stages));
        ++m;
      }
      mbar_wait(full + 8 * (m % stages), (m / stages) & 1);
      held = *static_cast<volatile int*>(chunk_of + m % stages);
    }
    held_lo = c * rows;
    held_hi = held_lo + rows;
    stage_at = (m % stages) * static_cast<int>(stage_words);
  };
  // Up to 2048 live candidates the window holds every word, and chunks of a
  // word or more start on a word: a word's rows are then held at once, and
  // the chain needs no branch but its loop.
  const bool lean = live_words <= 32 && rows % kTile == 0;
  for (int w = 0; w < live_words && step < max_det; ++w) {
    if (w == base + 32) {          // the window moves on
      base = w;
      removed = window(base);
    }
    if (lane == 0) *cursor = w * kTile;
    const int mine = base + lane;  // this lane's word
    const bool later = mine > w && mine < live_words;
    const uint64_t avail = ~__shfl_sync(~0u, removed, w - base);
    uint64_t picked = 0;
    if (lean) {
      if (w * kTile >= held_hi) acquire(w * kTile);
      // word w of row w * 64 + r is ring[diag + r * Wp]; the chain runs on
      // 32-bit halves
      const int diag = stage_at + (w * kTile - held_lo) * Wp + w;
      const uint32_t* ring32 = reinterpret_cast<const uint32_t*>(ring);
      uint32_t lo = static_cast<uint32_t>(avail);
      uint32_t hi = static_cast<uint32_t>(avail >> 32);
      uint32_t picked_lo = 0, picked_hi = 0;
      uint64_t own = 0;
      while (lo != 0) {
        const uint32_t low = lo & (0u - lo);
        const int at = diag + (31 - __clz(low)) * Wp;
        const uint64_t d = ring[at];
        if (later) own |= ring[at - w + mine];
        picked_lo |= low;
        lo &= ~(low | static_cast<uint32_t>(d));
        hi &= ~static_cast<uint32_t>(d >> 32);
      }
      while (hi != 0) {
        const uint32_t low = hi & (0u - hi);
        const int at = diag + (63 - __clz(low)) * Wp;
        if (later) own |= ring[at - w + mine];
        picked_hi |= low;
        hi &= ~(low | ring32[2 * at + 1]);
      }
      removed |= own;
      picked = static_cast<uint64_t>(picked_hi) << 32 | picked_lo;
    } else {
      // word w of row w * 64 + bit is ring[diag + bit * Wp] while
      // bit < lim, the end of the held load
      int lim = held_hi - w * kTile;
      int diag = lim > 0 ? stage_at + (w * kTile - held_lo) * Wp + w : 0;
      uint64_t open = avail;
      while (open != 0) {
        const int bit = __ffsll(static_cast<long long>(open)) - 1;
        if (bit >= lim) {          // the pick's row lies in a later load
          acquire(w * kTile + bit);
          lim = held_hi - w * kTile;
          diag = stage_at + (w * kTile - held_lo) * Wp + w;
        }
        const int at = diag + bit * Wp;
        const uint64_t low = open & (0ull - open);
        picked |= low;
        open &= ~(low | ring[at]);  // the pick and what it suppresses
        if (later) removed |= ring[at - w + mine];
        for (int v = base + 32 + lane; v < live_words; v += 32)
          far[v] |= ring[at - w + v];
      }
    }
    // the word's picks, in index order, to slots step, step + 1, ...
    for (int bit = lane; bit < kTile; bit += 32) {
      const int s = step + __popcll(picked & ((1ull << bit) - 1));
      if ((picked >> bit & 1) && s < max_det) {
        kp[s] = w * kTile + bit;
        okp[s] = w * kTile + bit < pos;
      }
    }
    step += __popcll(picked);
  }
  for (int s = min(step, max_det) + lane; s < max_det; s += 32) {
    kp[s] = 0;
    okp[s] = false;
  }
  if (lane == 0) *done = 1;
}

bool g_opt_in[kMaxDevices];

}  // namespace

// mask: a (B, K, Wp) 64-bit scratch, Wp = ceil(K / 64) rounded up to even
// (kernels/nms.py: mask_words)
extern "C" int icaf_greedy_nms(const void* boxes, const void* scores,
                               void* mask, void* keep, void* ok, int B,
                               int K, int max_det, float iou_thres,
                               void* stream) {
  if (B == 0) return cudaSuccess;
  if (B > 65535 || K < 1 || max_det < 1 || mask == nullptr)
    return cudaErrorInvalidValue;
  const int words = (K + kTile - 1) / kTile;
  const int Wp = words + (words & 1);
  const long long row_bytes = 8LL * Wp;
  // rows a chunk: a multiple of 64 where 16 KB hold a word of rows, so
  // that chunks start on a word
  int rows = static_cast<int>(std::max(
      1LL, std::min<long long>(words * kTile, kChunkBytes / row_bytes)));
  if (rows > kTile) rows -= rows % kTile;
  const long long stage_bytes = rows * row_bytes;
  const int chunks = (K + rows - 1) / rows;
  const int stages = static_cast<int>(std::max(1LL, std::min<long long>(
      std::min(kMaxStages, chunks), kRingBytes / stage_bytes)));
  const long long smem = stages * stage_bytes + row_bytes + 16LL * stages +
                         4LL * stages;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = opt_in_smem(nms_scan_kernel, kMaxSmem, g_opt_in);
  if (err != cudaSuccess) return err;

  auto st = static_cast<cudaStream_t>(stream);
  auto m = static_cast<uint64_t*>(mask);
  const long long tiles = static_cast<long long>(words) * (words + 1) / 2;
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(tiles), B);
  const auto bx = static_cast<const float*>(boxes);
  const auto sc = static_cast<const float*>(scores);
  if (tiles * B <= kSmallGrid)
    nms_mask_kernel<4><<<grid, kTile * 4, 0, st>>>(bx, sc, m, K, Wp, iou_thres);
  else
    nms_mask_kernel<1><<<grid, kTile, 0, st>>>(bx, sc, m, K, Wp, iou_thres);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nms_scan_kernel<<<B, kScanThreads, static_cast<size_t>(smem), st>>>(
      sc, m, static_cast<int*>(keep), static_cast<bool*>(ok), K, Wp, max_det,
      rows, stages);
  return cudaGetLastError();
}
