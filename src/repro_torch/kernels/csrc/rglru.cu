// rglru.cu — the RG-LRU linear recurrence h_t = exp(log_a_t)·h_{t−1} + b_t
// for sm_90a.
//
// Replaces src/repro/kernels/rglru.py:rglru_pallas (_rglru_kernel), the
// Pallas TPU kernel whose grid walks time blocks along a sequential axis and
// carries a (block_w,) f32 state in VMEM scratch.
//
//   log_a, b (B,S,W) f32 -> h (B,S,W) f32, over axis 1 from h = 0.
//
// Bound on the H100: the recurrence is elementwise across (B, W), so it
// does 2 FLOP and one exp per element and moves 12 bytes (log_a and b read,
// h written): bytes bound it.  At recurrentgemma-9b's prefill shape (B=2,
// S=2560, W=4096) that is 252 MB, 75 us at 3.35 TB/s.
//
// Design: one thread per (b, w) channel loops over time, neighbouring
// threads on neighbouring w, so each warp's loads and stores at one time
// step are 128 contiguous bytes.  The loads do not depend on h, so each
// thread issues UNROLL time steps of loads before it runs their recurrence,
// to keep bytes in flight.  At B=2, W=4096 this launches only 8192 threads
// (128 blocks of 64, about one per SM): too few to cover the memory latency
// at the full rate.  A chunked scan over time (per-chunk local scans, then
// the chunk carries) would give every SM more work; it is left for later.
#include "common.cuh"

namespace {

constexpr int THREADS = 64, UNROLL = 16;

__global__ void __launch_bounds__(THREADS)
rglru_kernel(const float* __restrict__ log_a, const float* __restrict__ b,
             float* __restrict__ h, int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const size_t base = (size_t)blockIdx.y * S * W + w;
  float hv = 0.f;
  int t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
    float la[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const size_t o = base + (size_t)(t + u) * W;
      la[u] = __ldg(log_a + o);
      bv[u] = __ldg(b + o);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      hv = fmaf(expf(la[u]), hv, bv[u]);
      h[base + (size_t)(t + u) * W] = hv;
    }
  }
  for (; t < S; ++t) {
    const size_t o = base + (size_t)t * W;
    hv = fmaf(expf(__ldg(log_a + o)), hv, __ldg(b + o));
    h[o] = hv;
  }
}

}  // namespace

extern "C" int rglru_launch(const void* log_a, const void* b, void* h, int B,
                            int S, int W, void* stream) {
  if (B < 0 || S < 0 || W < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || W == 0) return 0;
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(b),
      static_cast<float*>(h), S, W);
  return static_cast<int>(cudaGetLastError());
}

RT_ERROR_STRING(rglru)
