// Greedy-NMS keep mask, one CTA per frame, for sm_90a.
//
// Replaces the TPU kernel manual_yolo_tpu/ops/pallas_nms.py::_nms_kernel
// (entry pallas_nms_keep). It computes the same mask: over K candidates in
// score-descending order (class offsets already applied to the boxes), box i
// is kept iff it is valid and no earlier kept box j has
//     inter / (area_j + area_i - inter + 1e-7) > iou_thres.
// No K x K matrix is built.
//
// What bounds it on this card: not bytes (~9 KB a frame at K=512, a few ns
// of HBM time) and not operations (an IoU is a handful of min/max, one
// product and one division per pair; there is no product of matrices, so
// wgmma and the tensor cores have nothing to do here). The greedy scan is a
// serial chain: the launch, the staging copy's latency, then one step per
// chunk of 32 candidates, each a fixed cost (two block barriers and a
// 32-step resolve in one warp) plus the chunk's tests against the boxes
// kept so far, which grow with them and run on this CTA's one SM. A scan
// with one block barrier per candidate pays n_valid round trips instead of
// 2 * ceil(n_valid / 32).
//
// Design: a chunked greedy scan.
//  * Stage. Thread 0 arms an mbarrier and copies the frame's K x 16 B of
//    boxes into shared memory with one bulk asynchronous copy (TMA);
//    meanwhile the warps ballot `valid` into one word per 32 candidates and
//    find the last valid one, n - 1. Areas follow in shared memory. Shared
//    memory holds 22 B and 1 bit per candidate (box 16, area 4, kept-list
//    index 2, valid bit), so K <= 2048 fits the 48 KB a launch may take
//    without opting in.
//  * Chunk c covers candidates c0 = 32c .. c0 + 31, lane l taking c0 + l.
//    (a) Every warp tests the chunk's candidates against its share of the
//        boxes kept in earlier chunks (kept boxes are dealt to the warps
//        round robin, in the order they were kept), four boxes at a time,
//        and ballots the hits into one word; the warps also split the
//        32 x 32 pairs inside the chunk, one ballot per earlier lane lj
//        giving col[lj], the later lanes that lj overlaps. One
//        __syncthreads.
//    (b) Warp 0 alone resolves the chunk with warp-uniform scalar work:
//        alive = valid & ~(OR of the hit words); for lj = 0..31, if lj is
//        alive it is kept and clears col[lj] from alive. It writes the
//        chunk's 32 keep bytes and deals the kept candidates to the warps'
//        lists. One __syncthreads.
//    (Every warp resolving the chunk itself would save the second barrier,
//    but 16 copies of the 32-step chain contend for the SM's 4 schedulers
//    and cost more than the barrier; measured, PERF.md.)
//  * Tail. Past the last chunk, keep is written as zeros.
// The scan stops after the last valid candidate. The callers give valid as a
// prefix (top-k sorted scores against a threshold), so that is n_valid, the
// Pallas kernel's trip count; for any other pattern it still equals the full
// greedy scan over K, since invalid candidates are never alive.
//
// Bit-exactness with the jnp scan and the Pallas kernel: every IoU is the
// earlier box j against candidate i, area and inter in the order of
// pallas_nms.py:44,61-68, and the file is compiled with -fmad=false and
// without --use_fast_math, so no product is contracted into an FMA and the
// division is IEEE-rounded. A pair is divided only if its quotient could be
// above the threshold (maybe_above); the others are below it for certain.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The terms of the IoU of the earlier box a (j) against candidate b (i), in
// the order of pallas_nms.py:61-68: iou = inter / denom.
__device__ __forceinline__ void iou_terms(float4 a, float area_a, float4 b, float area_b,
                                          float& inter, float& denom) {
  const float ix1 = fmaxf(a.x, b.x);
  const float iy1 = fmaxf(a.y, b.y);
  const float ix2 = fminf(a.z, b.z);
  const float iy2 = fminf(a.w, b.w);
  inter = fmaxf(ix2 - ix1, 0.0f) * fmaxf(iy2 - iy1, 0.0f);
  denom = area_a + area_b - inter + 1e-7f;
}

// May inter / denom be above the threshold? near_scale is 0.99f * iou_thres
// (or -inf, which sends every pair to the division). If inter <=
// near_scale * denom (two products, each rounded), then inter / denom <=
// 0.99f * (1 + 2^-24)^2 * iou_thres < iou_thres, and the rounded quotient is
// not above the threshold either: such a pair needs no division.
__device__ __forceinline__ bool maybe_above(float inter, float denom, float near_scale) {
  return inter > near_scale * denom;
}

// The decision itself: the IEEE-rounded quotient against the threshold.
__device__ __forceinline__ bool above(float inter, float denom, float near_scale,
                                      float iou_thres) {
  return maybe_above(inter, denom, near_scale) && inter / denom > iou_thres;
}

__global__ void __launch_bounds__(kThreads)
nms_keep_kernel(const float4* __restrict__ boxes,  // (B, K) xyxy
                const uint8_t* __restrict__ valid, // (B, K) 0/1
                uint8_t* __restrict__ keep,        // (B, K) 0/1
                int k, float iou_thres) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (k + 31) / 32;
  const int list_cap = (k + kWarps - 1) / kWarps;
  float4* box = reinterpret_cast<float4*>(smem);
  float* area = reinterpret_cast<float*>(box + k);
  uint32_t* valid_bits = reinterpret_cast<uint32_t*>(area + k);
  uint16_t* kept_list = reinterpret_cast<uint16_t*>(valid_bits + words);
  __shared__ __align__(8) uint64_t bar;
  __shared__ int last_valid;
  __shared__ int kept_total;  // boxes kept in the chunks resolved so far
  __shared__ uint32_t hit_words[kWarps];
  __shared__ __align__(16) uint32_t col_words[32];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const float4* fb = boxes + static_cast<size_t>(blockIdx.x) * k;
  const uint8_t* fv = valid + static_cast<size_t>(blockIdx.x) * k;
  uint8_t* fk = keep + static_cast<size_t>(blockIdx.x) * k;
  const uint16_t* my_list = kept_list + warp * list_cap;

  // --- stage ---------------------------------------------------------------
  const uint32_t bar_addr = smem_u32(&bar);
  if (tid == 0) {
    last_valid = -1;
    kept_total = 0;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_addr) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const uint32_t bytes = static_cast<uint32_t>(k) * 16u;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar_addr), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_u32(box)), "l"(__cvta_generic_to_global(fb)), "r"(bytes), "r"(bar_addr)
        : "memory");
  }
  __syncthreads();
  for (int w = warp; w < words; w += kWarps) {
    const int j = w * 32 + lane;
    const uint32_t bits = __ballot_sync(kFull, j < k && fv[j]);
    if (lane == 0) {
      valid_bits[w] = bits;
      if (bits) atomicMax(&last_valid, w * 32 + 31 - __clz(bits));
    }
  }
  for (uint32_t done = 0; !done;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar_addr) : "memory");
  }
  for (int j = tid; j < k; j += kThreads) {
    const float4 b = box[j];
    area[j] = fmaxf(b.z - b.x, 0.0f) * fmaxf(b.w - b.y, 0.0f);
  }
  __syncthreads();
  const int n = last_valid + 1;
  const int chunks = (n + 31) / 32;
  for (int j = chunks * 32 + tid; j < k; j += kThreads) fk[j] = 0;

  // --- scan, 32 candidates a chunk ------------------------------------------
  const float near_scale = iou_thres >= 1e-6f ? 0.99f * iou_thres : -INFINITY;
  for (int c = 0; c < chunks; ++c) {
    const int c0 = c * 32;
    const int kept = kept_total;
    const int i = c0 + lane;
    const bool live = i < n;
    float4 bi = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float ai = 0.0f;
    if (live) {
      bi = box[i];
      ai = area[i];
    }

    // (a) against this warp's share of the earlier chunks' kept boxes, four
    // at a time so that their terms are computed side by side ...
    const int owned = kept > warp ? (kept - warp + kWarps - 1) / kWarps : 0;
    bool hit = false;
    int s = 0;
    for (; s + 4 <= owned; s += 4) {
      float inter[4], denom[4];
      bool maybe = false;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = my_list[s + u];
        iou_terms(box[j], area[j], bi, ai, inter[u], denom[u]);
        maybe |= maybe_above(inter[u], denom[u], near_scale);
      }
      if (maybe) {
#pragma unroll
        for (int u = 0; u < 4; ++u) hit |= above(inter[u], denom[u], near_scale, iou_thres);
      }
    }
    for (; s < owned; ++s) {
      const int j = my_list[s];
      float inter, denom;
      iou_terms(box[j], area[j], bi, ai, inter, denom);
      hit |= above(inter, denom, near_scale, iou_thres);
    }
    const uint32_t hits = __ballot_sync(kFull, live && hit);
    if (lane == 0) hit_words[warp] = hits;
    // ... and this warp's columns of the chunk's own pairs (j < i < n <= k)
    for (int lj = warp; lj < 32; lj += kWarps) {
      const int j = c0 + lj;
      bool over = false;
      if (live && lj < lane) {
        float inter, denom;
        iou_terms(box[j], area[j], bi, ai, inter, denom);
        over = above(inter, denom, near_scale, iou_thres);
      }
      const uint32_t col = __ballot_sync(kFull, over);
      if (lane == 0) col_words[lj] = col;
    }
    __syncthreads();

    // (b) warp 0 alone resolves the chunk: the 32 column words go to
    // registers first, then a branch-free chain of 32 selects
    if (warp == 0) {
      uint32_t col[32];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint4 v = reinterpret_cast<const uint4*>(col_words)[q];
        col[4 * q] = v.x;
        col[4 * q + 1] = v.y;
        col[4 * q + 2] = v.z;
        col[4 * q + 3] = v.w;
      }
      const uint32_t pre = __reduce_or_sync(kFull, lane < kWarps ? hit_words[lane] : 0u);
      uint32_t alive = valid_bits[c] & ~pre;
#pragma unroll
      for (int lj = 0; lj < 32; ++lj) alive = (alive >> lj & 1u) ? alive & ~col[lj] : alive;
      const bool mine = alive >> lane & 1u;
      if (i < k) fk[i] = mine;
      if (mine) {  // deal the kept candidates to the warps' lists
        const int ordinal = kept + __popc(alive & ((1u << lane) - 1u));
        kept_list[ordinal % kWarps * list_cap + ordinal / kWarps] = static_cast<uint16_t>(i);
      }
      if (lane == 0) kept_total = kept + __popc(alive);
    }
    __syncthreads();
  }
}

// Shared bytes for K candidates: boxes, areas, valid words, kept lists.
size_t smem_bytes(int k) {
  const size_t words = (static_cast<size_t>(k) + 31) / 32;
  const size_t list_cap = (static_cast<size_t>(k) + kWarps - 1) / kWarps;
  return static_cast<size_t>(k) * (sizeof(float4) + sizeof(float)) + words * sizeof(uint32_t) +
         kWarps * list_cap * sizeof(uint16_t);
}

}  // namespace

extern "C" {

// Launches one CTA of kThreads per frame on `stream`; returns
// cudaGetLastError(). The wrapper keeps k <= 2048, so the shared memory stays
// inside the 48 KB a launch may take without opting in.
int nms_keep_launch(const void* boxes, const void* valid, void* keep,
                    int batch, int k, float iou_thres, void* stream) {
  nms_keep_kernel<<<batch, kThreads, smem_bytes(k),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, iou_thres);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
