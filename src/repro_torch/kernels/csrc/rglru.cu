// rglru.cu — the RG-LRU linear recurrence h_t = exp(log_a_t)·h_{t−1} + b_t
// for sm_90a.
//
// Replaces src/repro/kernels/rglru.py:rglru_pallas (_rglru_kernel), the
// Pallas TPU kernel whose grid walks time blocks along a sequential axis and
// carries a (block_w,) f32 state in VMEM scratch.
//
//   log_a, b (B,S,W) f32 -> h (B,S,W) f32, over axis 1 from h = 0.
//
// Bound on the NVIDIA H100 80GB HBM3 at its 700.00 W limit (the published
// 3.35 TB/s): the recurrence is elementwise across (B, W), so it
// does 2 FLOP and one exp per element and moves 12 bytes (log_a and b read,
// h written): bytes bound it.  At recurrentgemma-9b's prefill shape (B=2,
// S=2560, W=4096) that is 252 MB, 75 us at 3.35 TB/s.
//
// Design: a chunked scan over time inside each block, split across warps.
// One block of WARPS warps covers 32 channels (lane = channel, so a warp's
// load of one time step is 128 contiguous bytes) of one batch row over the
// whole sequence, in windows of WARPS·SEG steps.  In a window, warp k takes
// the SEG steps [t0 + k·SEG, t0 + (k+1)·SEG): each lane scans them from
// h = 0, keeping the local values and the running product of a = exp(log_a)
// in registers.  The warps' (product, end value) pairs meet in shared
// memory; every thread folds them in warp order from the window's carry-in,
// c ← product·c + end, which gives its own warp's carry-in on the way and
// the next window's carry at the end (the same fixed order in every thread:
// no atomics, and two launches agree bit for bit).  Each lane then writes
// h_t = local_t + product_t·carry_in.  Every warp issues all 2·SEG loads of
// its segment before it uses any, and loads the next window's while the
// current one is combined and stored; with 8 warps x SEG 32 that is 64 KB
// in flight a block, 16 MB over the 256 blocks of the prefill shape
// (Little's law at 3.35 TB/s and ~1 us of memory latency asks for ~3 MB;
// the longer segments also halve the block's syncs a step).  The
// carry never leaves the block.  Steps past S and channels past W load as
// (log_a, b) = (0, 0), a step that changes nothing, and are never stored.
// The accurate expf is kept.
#include "common.cuh"

namespace {

constexpr int LANES = 32, WARPS = 8, SEG = 32, THREADS = LANES * WARPS;
constexpr int WINDOW = WARPS * SEG;

__global__ void __launch_bounds__(THREADS)
rglru_kernel(const float* __restrict__ log_a, const float* __restrict__ b,
             float* __restrict__ h, int S, int W) {
  __shared__ float2 ends[2][WARPS][LANES];  // (product, end value), by window parity
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w = blockIdx.x * LANES + lane;
  const bool live = w < W;
  const size_t base = (size_t)blockIdx.y * S * W + w;

  float la[SEG], bv[SEG];
#pragma unroll
  for (int u = 0; u < SEG; ++u) {
    const int t = warp * SEG + u;
    const bool ok = live && t < S;
    la[u] = ok ? __ldg(log_a + base + (size_t)t * W) : 0.f;
    bv[u] = ok ? __ldg(b + base + (size_t)t * W) : 0.f;
  }

  float carry = 0.f;
  for (int t0 = 0, it = 0; t0 < S; t0 += WINDOW, ++it) {
    // the segment scanned from h = 0
    float loc[SEG], prod[SEG];
    float hv = 0.f, p = 1.f;
#pragma unroll
    for (int u = 0; u < SEG; ++u) {
      const float a = expf(la[u]);
      hv = fmaf(a, hv, bv[u]);
      p *= a;
      loc[u] = hv;
      prod[u] = p;
    }
    // the next window's loads, in flight while this one is combined
    if (t0 + WINDOW < S) {
#pragma unroll
      for (int u = 0; u < SEG; ++u) {
        const int t = t0 + WINDOW + warp * SEG + u;
        const bool ok = live && t < S;
        la[u] = ok ? __ldg(log_a + base + (size_t)t * W) : 0.f;
        bv[u] = ok ? __ldg(b + base + (size_t)t * W) : 0.f;
      }
    }
    float2(&e)[WARPS][LANES] = ends[it & 1];
    e[warp][lane] = make_float2(p, hv);
    __syncthreads();
    float c = carry, cin = 0.f;
#pragma unroll
    for (int m = 0; m < WARPS; ++m) {
      if (m == warp) cin = c;
      const float2 pe = e[m][lane];
      c = fmaf(pe.x, c, pe.y);
    }
    carry = c;
#pragma unroll
    for (int u = 0; u < SEG; ++u) {
      const int t = t0 + warp * SEG + u;
      if (live && t < S) h[base + (size_t)t * W] = fmaf(prod[u], cin, loc[u]);
    }
  }
}

}  // namespace

extern "C" int rglru_launch(const void* log_a, const void* b, void* h, int B,
                            int S, int W, void* stream) {
  rt::smem_requested() = 0;  // static shared memory only
  if (B < 0 || S < 0 || W < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || W == 0) return 0;
  const dim3 grid((W + LANES - 1) / LANES, B);
  rglru_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(b),
      static_cast<float*>(h), S, W);
  return static_cast<int>(cudaGetLastError());
}

RT_ERROR_STRING(rglru)
RT_REQUESTED_SMEM(rglru)
