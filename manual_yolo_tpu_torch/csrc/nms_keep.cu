// Greedy-NMS keep mask, one CTA per frame, for sm_90a.
//
// Replaces the TPU kernel manual_yolo_tpu/ops/pallas_nms.py::_nms_kernel
// (entry pallas_nms_keep). It computes the same mask: over K candidates in
// score-descending order (class offsets already applied to the boxes), box i
// is kept iff it is valid and no earlier kept box j has
//     inter / (area_j + area_i - inter + 1e-7) > iou_thres.
// No K x K matrix is built.
//
// What bounds it: the scan is a serial chain of n_valid steps, each ending in
// one block-wide barrier (__syncthreads_or). Its bytes are ~9 KB at K=512
// (boxes 8 KB, valid and keep 0.5 KB each), a few ns of HBM time, and its
// arithmetic is tiny; the floor is the launch latency plus n_valid barrier
// round trips, not bandwidth or FLOPs.
//
// Design:
//  * the CTA stages its frame's boxes and areas in shared memory (20 B per
//    candidate) and finds the scan length itself, so the host never syncs;
//  * step i: threads stride over j < i, test keep[j] && iou(i, j) > t, and
//    __syncthreads_or gives every thread the verdict. keep[j] lives in the
//    shared slot owned by thread j % blockDim.x, and only that thread ever
//    reads or writes it, so one barrier per step is enough;
//  * the scan stops after the last valid candidate. The callers give valid
//    as a prefix (top-k sorted scores against a threshold), so that is
//    n_valid, the Pallas kernel's trip count; for any other pattern it still
//    equals the full greedy scan over K.
//
// Bit-exactness with the jnp scan and the Pallas kernel: area and inter are
// computed in the same order as pallas_nms.py:44,61-68, and the file is
// compiled with -fmad=false and without --use_fast_math, so no product is
// contracted into an FMA and the division is IEEE-rounded.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
nms_keep_kernel(const float* __restrict__ boxes,   // (B, K, 4) xyxy
                const uint8_t* __restrict__ valid, // (B, K) 0/1
                uint8_t* __restrict__ keep,        // (B, K) 0/1
                int k, float iou_thres) {
  extern __shared__ float smem[];
  float* x1 = smem;
  float* y1 = x1 + k;
  float* x2 = y1 + k;
  float* y2 = x2 + k;
  float* area = y2 + k;
  uint8_t* kept = reinterpret_cast<uint8_t*>(area + k);
  __shared__ int last_valid;

  const int tid = threadIdx.x;
  const float* fb = boxes + static_cast<size_t>(blockIdx.x) * k * 4;
  const uint8_t* fv = valid + static_cast<size_t>(blockIdx.x) * k;
  uint8_t* fk = keep + static_cast<size_t>(blockIdx.x) * k;

  if (tid == 0) last_valid = -1;
  __syncthreads();
  int my_last = -1;
  for (int j = tid; j < k; j += kThreads) {
    const float4 b = reinterpret_cast<const float4*>(fb)[j];
    x1[j] = b.x;
    y1[j] = b.y;
    x2[j] = b.z;
    y2[j] = b.w;
    area[j] = fmaxf(b.z - b.x, 0.0f) * fmaxf(b.w - b.y, 0.0f);
    kept[j] = 0;
    if (fv[j]) my_last = j;
  }
  if (my_last >= 0) atomicMax(&last_valid, my_last);
  __syncthreads();
  const int n = last_valid + 1;

  for (int i = 0; i < n; ++i) {
    const float bx1 = x1[i], by1 = y1[i], bx2 = x2[i], by2 = y2[i];
    const float barea = area[i];
    int hit = 0;
    for (int j = tid; j < i; j += kThreads) {
      if (kept[j]) {
        const float ix1 = fmaxf(x1[j], bx1);
        const float iy1 = fmaxf(y1[j], by1);
        const float ix2 = fminf(x2[j], bx2);
        const float iy2 = fminf(y2[j], by2);
        const float inter = fmaxf(ix2 - ix1, 0.0f) * fmaxf(iy2 - iy1, 0.0f);
        const float iou = inter / (area[j] + barea - inter + 1e-7f);
        hit |= iou > iou_thres;
      }
    }
    const int suppressed = __syncthreads_or(hit);
    if (tid == i % kThreads) kept[i] = fv[i] && !suppressed;
  }
  __syncthreads();
  for (int j = tid; j < k; j += kThreads) fk[j] = kept[j];
}

}  // namespace

extern "C" {

// Launches one CTA per frame on `stream`; returns cudaGetLastError().
// Shared memory is 21 bytes per candidate, so k <= 2048 stays inside the
// 48 KB a launch may take without opting in (the wrapper enforces it).
int nms_keep_launch(const void* boxes, const void* valid, void* keep,
                    int batch, int k, float iou_thres, void* stream) {
  const size_t smem = static_cast<size_t>(k) * (5 * sizeof(float) + 1);
  nms_keep_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, iou_thres);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
