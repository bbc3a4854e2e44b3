// Greedy NMS selection loop, one thread block per image.
//
// Replaces the Pallas TPU kernel icafusion_tpu/kernels/nms.py:
// pallas_greedy_nms (body _nms_kernel). Semantics: max_det steps, each
//   1. picks the highest active score, ties to the lowest index (an image
//      whose scores are all -1 picks index 0, as jnp.argmax does);
//   2. computes the IoU row of the pick against every candidate, in the
//      operation order of kernels/nms.py:50-55;
//   3. sets the pick and every candidate with IoU > iou_thres to -1.
// keep[step] is the pick, ok[step] is (picked score > 0).
//
// What bounds it on the H100: neither bytes (K=1024 boxes are 20 KB per
// image) nor operations (a few FLOPs per candidate per step), but the serial
// chain of max_det = 300 dependent block-wide argmax reductions: each step
// needs the previous step's suppression. The design keeps that chain short:
// every thread holds its candidates (coordinates, area, active score) in
// registers for the whole loop, so a step is a register scan, five warp
// shuffles, one exchange through shared memory and two __syncthreads; the
// picked box is read back from global memory (an L1/L2 hit) instead of
// costing a third barrier. Images run in parallel, one block each.
//
// The IoU arithmetic uses __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn, which the
// compiler never contracts into fused multiply-adds, so a candidate exactly
// at the threshold is suppressed as the CPU and the plain PyTorch loop
// suppress it.

#include <cuda_runtime.h>
#include <cfloat>
#include <climits>

namespace {

constexpr int kThreads = 512;   // kernels/nms.py: THREADS
constexpr int kWarps = kThreads / 32;

// (v, i) beats (bv, bi): larger score, or equal score and lower index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <int ITEMS>
__global__ void __launch_bounds__(kThreads)
greedy_nms_kernel(const float* __restrict__ boxes,   // (B, K, 4)
                  const float* __restrict__ scores,  // (B, K)
                  int* __restrict__ keep,            // (B, max_det)
                  bool* __restrict__ ok,             // (B, max_det)
                  int K, int max_det, float iou_thres) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* bx = boxes + (size_t)b * K * 4;
  const float* sc = scores + (size_t)b * K;

  // candidate j = r * kThreads + tid lives in slot r of thread tid, so a
  // thread's slots hold ascending indices
  float x1[ITEMS], y1[ITEMS], x2[ITEMS], y2[ITEMS], area[ITEMS], act[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int j = r * kThreads + tid;
    if (j < K) {
      x1[r] = bx[j * 4 + 0];
      y1[r] = bx[j * 4 + 1];
      x2[r] = bx[j * 4 + 2];
      y2[r] = bx[j * 4 + 3];
      area[r] = __fmul_rn(__fsub_rn(x2[r], x1[r]), __fsub_rn(y2[r], y1[r]));
      act[r] = sc[j];
    } else {
      x1[r] = y1[r] = x2[r] = y2[r] = area[r] = 0.f;
      act[r] = -FLT_MAX;   // never wins: real scores are >= -1
    }
  }

  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ int s_pick[2];

  for (int step = 0; step < max_det; ++step) {
    // 1. block-wide argmax, ties to the lowest index
    float bv = -FLT_MAX;
    int bi = INT_MAX;
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      const int j = r * kThreads + tid;
      if (j < K && better(act[r], j, bv, bi)) { bv = act[r]; bi = j; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) { s_val[warp] = bv; s_idx[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? s_val[lane] : -FLT_MAX;
      bi = lane < kWarps ? s_idx[lane] : INT_MAX;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
      }
      if (lane == 0) {
        s_pick[step & 1] = bi;
        keep[(size_t)b * max_det + step] = bi;
        ok[(size_t)b * max_det + step] = bv > 0.f;
      }
    }
    __syncthreads();
    // s_pick is double-buffered: the slot written at step + 1 is not the
    // one read here, and the slot of step + 2 is written only after every
    // thread has passed step + 2's first barrier.
    const int i = s_pick[step & 1];

    // 2. the picked box, broadcast from global memory
    const float px1 = bx[i * 4 + 0], py1 = bx[i * 4 + 1];
    const float px2 = bx[i * 4 + 2], py2 = bx[i * 4 + 3];
    const float barea = __fmul_rn(__fsub_rn(px2, px1), __fsub_rn(py2, py1));

    // 3. IoU row and suppression (kernels/nms.py:50-55)
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      const float iw = fmaxf(__fsub_rn(fminf(x2[r], px2), fmaxf(x1[r], px1)), 0.f);
      const float ih = fmaxf(__fsub_rn(fminf(y2[r], py2), fmaxf(y1[r], py1)), 0.f);
      const float inter = __fmul_rn(iw, ih);
      const float den = __fadd_rn(__fsub_rn(__fadd_rn(area[r], barea), inter),
                                  1e-12f);
      const float iou = __fdiv_rn(inter, den);
      const int j = r * kThreads + tid;
      if (j < K && (iou > iou_thres || j == i)) act[r] = -1.f;
    }
  }
}

template <int ITEMS>
cudaError_t launch(const float* boxes, const float* scores, int* keep,
                   bool* ok, int B, int K, int max_det, float iou_thres,
                   cudaStream_t stream) {
  greedy_nms_kernel<ITEMS><<<B, kThreads, 0, stream>>>(
      boxes, scores, keep, ok, K, max_det, iou_thres);
  return cudaGetLastError();
}

}  // namespace

extern "C" int icaf_greedy_nms(const void* boxes, const void* scores,
                               void* keep, void* ok, int B, int K,
                               int max_det, float iou_thres, void* stream) {
  if (B == 0) return cudaSuccess;
  auto b = static_cast<const float*>(boxes);
  auto s = static_cast<const float*>(scores);
  auto k = static_cast<int*>(keep);
  auto o = static_cast<bool*>(ok);
  auto st = static_cast<cudaStream_t>(stream);
  const int items = (K + kThreads - 1) / kThreads;
  if (items <= 1) return launch<1>(b, s, k, o, B, K, max_det, iou_thres, st);
  if (items <= 2) return launch<2>(b, s, k, o, B, K, max_det, iou_thres, st);
  if (items <= 4) return launch<4>(b, s, k, o, B, K, max_det, iou_thres, st);
  if (items <= 8) return launch<8>(b, s, k, o, B, K, max_det, iou_thres, st);
  if (items <= 16) return launch<16>(b, s, k, o, B, K, max_det, iou_thres, st);
  return cudaErrorInvalidValue;
}
