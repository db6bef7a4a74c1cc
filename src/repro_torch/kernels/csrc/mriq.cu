// mriq.cu — Parboil MRI-Q, the paper's own application, for sm_90a.
//
// Replaces src/repro/kernels/mriq.py:mriq_pallas (_mriq_kernel), the Pallas TPU
// kernel that tiles voxels into VMEM blocks and streams k-space chunks along a
// sequential grid axis into f32 scratch.
//
//   Qr(n) = sum_m phi[m] * cos(2*pi*(x[n]*kx[m] + y[n]*ky[m] + z[n]*kz[m]))
//   Qi(n) = sum_m phi[m] * sin(...)
//
// Bound on the H100: operations.  At the paper's size (N = 64^3 voxels, M = 3072
// k-space points) it is 16 FLOP per (voxel, k) pair, 12.9 GFLOP on the f32
// CUDA cores (67 TFLOP/s): 0.19 ms, against a few MB moved.  The sines and
// cosines dominate the instruction count.
//
// Design: one thread per voxel keeps Qr/Qi in f32 registers; each block stages
// k-space chunks of (kx, ky, kz, phi) as float4s in shared memory, so the k
// loop is one broadcast shared load per pair.  The angle keeps the reference's
// order of operations, 2*pi*((x*kx + y*ky) + z*kz), with no fused
// multiply-add contraction (__fmul_rn/__fadd_rn), and is taken with the
// accurate sincosf: angles reach tens of radians, where __sinf/__cosf and
// --use_fast_math lose digits the tolerance needs.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 1024;  // k-space points per shared-memory stage (16 KB)
constexpr float TWO_PI = 6.283185307179586f;

__global__ void __launch_bounds__(THREADS)
mriq_kernel(const float* __restrict__ kx, const float* __restrict__ ky,
            const float* __restrict__ kz, const float* __restrict__ phi,
            const float* __restrict__ x, const float* __restrict__ y,
            const float* __restrict__ z, float* __restrict__ qr,
            float* __restrict__ qi, int n, int m) {
  __shared__ float4 ks[CHUNK];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const float xv = i < n ? x[i] : 0.f;
  const float yv = i < n ? y[i] : 0.f;
  const float zv = i < n ? z[i] : 0.f;
  float ar = 0.f, ai = 0.f;
  for (int c0 = 0; c0 < m; c0 += CHUNK) {
    const int len = min(CHUNK, m - c0);
    for (int j = threadIdx.x; j < len; j += THREADS)
      ks[j] = make_float4(kx[c0 + j], ky[c0 + j], kz[c0 + j], phi[c0 + j]);
    __syncthreads();
    for (int j = 0; j < len; ++j) {
      const float4 k = ks[j];
      float ang = __fadd_rn(__fadd_rn(__fmul_rn(xv, k.x), __fmul_rn(yv, k.y)),
                            __fmul_rn(zv, k.z));
      ang = __fmul_rn(TWO_PI, ang);
      float s, c;
      sincosf(ang, &s, &c);
      ar = fmaf(k.w, c, ar);
      ai = fmaf(k.w, s, ai);
    }
    __syncthreads();
  }
  if (i < n) {
    qr[i] = ar;
    qi[i] = ai;
  }
}

}  // namespace

extern "C" int mriq_launch(const void* kx, const void* ky, const void* kz,
                           const void* phi, const void* x, const void* y,
                           const void* z, void* qr, void* qi, int n, int m,
                           void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  mriq_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(kx), static_cast<const float*>(ky),
      static_cast<const float*>(kz), static_cast<const float*>(phi),
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(z), static_cast<float*>(qr),
      static_cast<float*>(qi), n, m);
  return static_cast<int>(cudaGetLastError());
}

RT_ERROR_STRING(mriq)
