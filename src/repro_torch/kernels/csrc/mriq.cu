// mriq.cu — Parboil MRI-Q, the paper's own application, for sm_90a.
//
// Replaces src/repro/kernels/mriq.py:mriq_pallas (_mriq_kernel), the Pallas TPU
// kernel that tiles voxels into VMEM blocks and streams k-space chunks along a
// sequential grid axis into f32 scratch.
//
//   Qr(n) = sum_m phi[m] * cos(2*pi*(x[n]*kx[m] + y[n]*ky[m] + z[n]*kz[m]))
//   Qi(n) = sum_m phi[m] * sin(...)
//
// Bound on the H100: operations.  At the paper's size (N = 64^3 voxels,
// M = 3072 k-space points) it is 16 FLOP per (voxel, k) pair, 12.9 GFLOP on
// the f32 CUDA cores (67 TFLOP/s): 0.19 ms, against a few MB moved.  What the card
// really spends is issue: a pair takes at least 10 FP32 instructions and a
// sine and a cosine, and the special-function unit (SFU) gives 16 lanes an
// SM a clock, 0.385 ms for two MUFUs a pair at 1.98 GHz.
//
// Design, for the card's pipes:
//
// 1. The phase in turns, reduced exactly.  t = fmaf(x, kx, fmaf(y, ky, z*kz))
//    and r = t - rint(t) in [-1/2, 1/2]; rint by the magic constant 1.5*2^23
//    (two FADDs, on the FP32 pipe; rintf's FRND measured slower).  For
//    |t| < 2^22 the subtraction is exact, so the only angle error left is
//    the rounding of t itself (beyond 2^22 the f32 phase holds no fraction
//    of a turn).
// 2. sin and cos of 2*pi*r on the SFU: __sincosf(2*pi*r), MUFU.SIN and
//    MUFU.COS, documented to 2^-21.41 absolute error on [-pi, pi] (the
//    rounded 2*pi*r can pass pi by one ulp).  The source also holds an
//    FP32-pipe path for one pair in every POLY_EVERY of a thread's stream:
//    the quadrant q = rint(4r), f = r - q/4 in [-1/8, 1/8] (exact), odd
//    and even minimax polynomials of sin(2*pi*f) and cos(2*pi*f) in f^2 by
//    FMAs (max error 2^-23 with their roundings, ref.SINCOS_TURNS_MAX_ERR),
//    sign and swap from q's low bits.  On the H100 the two pipes do not
//    overlap as their rates suggest: a MUFU holds its sub-partition's issue
//    for about four clocks, and a polynomial pair (~26 instructions, a
//    third of them at half rate) costs about twice an SFU pair.  The sweep
//    of V and POLY_EVERY (scripts/kernel_ab.py, PERF.md) found 4 voxels a
//    thread with no pair on the polynomial fastest, so POLY_EVERY is 0 and
//    the polynomial path is compiled out; the sweep builds it.
//    Explicit intrinsics: the build keeps its flags (no fast-math flag).
// 3. Several voxels a thread.  Each thread keeps V voxels in registers, so
//    one broadcast shared load of (kx, ky, kz, phi) serves V pairs, with V
//    independent accumulator chains.  k-space is staged as float4s in
//    shared memory, CHUNK points (24 KB) at a time, padded with zeros
//    (phi = 0 adds exactly nothing) to whole groups, so the inner loop has
//    no ragged edge; shared and not __constant__ memory, because a constant
//    bank would need a copy into one symbol per call, shared by every
//    launch of the process (two streams would race on it), and caps M at
//    64 KB a copy.
// 4. The grid: tiles of THREADS*V voxels, one block each, MIN_BLOCKS of
//    them resident an SM (__launch_bounds__: at most 128 registers at 4
//    voxels).  At the paper's size, 256 blocks of 1024 voxels run in one
//    wave, 16 warps an SM: the busiest SM takes 2048 voxels, the least any
//    split of 262,144 voxels over 132 SMs into warps can give (1986 an SM
//    on average).
// 5. Sums: each voxel's pairs add into a group sum of GROUP k points by
//    fmaf, and the group sums into a compensated (Kahan) running sum, in k
//    order.  One thread writes each output and the order is fixed: two
//    launches agree bit for bit.  ref.mriq_f32_tolerance derives the
//    elementwise error bound of this arithmetic against the exact Q.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int V = 4;           // voxels a thread
constexpr int POLY_EVERY = 0;  // one pair in this many on the FP32 pipe; 0: none
constexpr int GROUP = 96;          // k points a group sum
constexpr int CHUNK = 16 * GROUP;  // k points a shared-memory stage (24 KB)
// blocks an SM must hold for the paper's 262,144 voxels to run in one wave
// (2048 voxels an SM, 1986 on average)
constexpr int MIN_BLOCKS = 2048 / (THREADS * V);
// k points a step of the inner loop.  In the thread's stream of pairs, k
// point by k point and voxel by voxel, pair m*V + v goes to the FP32 pipe
// when (m*V + v) % POLY_EVERY == POLY_EVERY - 1: spread evenly, so that the
// SFU queue and the FP32 pipe are fed at once, not in turns.
constexpr int STEP = POLY_EVERY ? POLY_EVERY : 8;
static_assert(GROUP % STEP == 0, "POLY_EVERY must divide the group");
static_assert(MIN_BLOCKS >= 1 && 2048 % (THREADS * V) == 0,
              "V must divide 8");

constexpr float TWO_PI = 6.283185307179586f;
constexpr float RINT_MAGIC = 12582912.f;  // 1.5 * 2^23

// sin(2*pi*f) = f * (SIN1 + SIN3 w + SIN5 w^2 + SIN7 w^3), w = f^2,
// cos(2*pi*f) = 1 + COS2 w + COS4 w^2 + COS6 w^3, minimax on |f| <= 1/8
// (approximation error 1.2e-9 and 3.2e-8).  Mirrored by ref.sincos_turns.
constexpr float SIN1 = 0x1.921fb4p+2f;
constexpr float SIN3 = -0x1.4abba8p+5f;
constexpr float SIN5 = 0x1.465a3ep+6f;
constexpr float SIN7 = -0x1.2cf5d4p+6f;
constexpr float COS2 = -0x1.3bd3a2p+4f;
constexpr float COS4 = 0x1.03b162p+6f;
constexpr float COS6 = -0x1.4ea9e8p+6f;

// t - rint(t), exact for |t| < 2^22
__device__ __forceinline__ float reduce_turns(float t) {
  const float n = __fsub_rn(__fadd_rn(t, RINT_MAGIC), RINT_MAGIC);
  return __fsub_rn(t, n);
}

// sin and cos of 2*pi*r, |r| <= 1/2, on the FP32 pipe
__device__ __forceinline__ void sincos_poly(float r, float& s, float& c) {
  const float u = fmaf(r, 4.f, RINT_MAGIC);  // RINT_MAGIC + rint(4r)
  const float q = __fsub_rn(u, RINT_MAGIC);
  const float f = fmaf(q, -0.25f, r);        // exact, |f| <= 1/8
  const float w = __fmul_rn(f, f);
  const float ps =
      __fmul_rn(fmaf(fmaf(fmaf(SIN7, w, SIN5), w, SIN3), w, SIN1), f);
  const float pc = fmaf(fmaf(fmaf(COS6, w, COS4), w, COS2), w, 1.f);
  // u's low bits hold q mod 4: odd q swaps sin and cos; sin changes sign for
  // q mod 4 in {2, 3}, cos for q mod 4 in {1, 2}
  const unsigned qb = __float_as_uint(u);
  const bool swap = qb & 1u;
  const float a = swap ? pc : ps;
  const float b = swap ? ps : pc;
  s = __uint_as_float(__float_as_uint(a) ^ ((qb << 30) & 0x80000000u));
  c = __uint_as_float(__float_as_uint(b) ^ (((qb + 1u) << 30) & 0x80000000u));
}

// a running sum with Kahan's compensation
struct Sum {
  float s = 0.f, c = 0.f;
  __device__ __forceinline__ void add(float g) {
    const float y = __fsub_rn(g, c);
    const float t = __fadd_rn(s, y);
    c = __fsub_rn(__fsub_rn(t, s), y);
    s = t;
  }
};

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
mriq_kernel(const float* __restrict__ kx, const float* __restrict__ ky,
            const float* __restrict__ kz, const float* __restrict__ phi,
            const float* __restrict__ x, const float* __restrict__ y,
            const float* __restrict__ z, float* __restrict__ qr,
            float* __restrict__ qi, int n, int m) {
  __shared__ float4 ks[CHUNK];
  const int i0 = blockIdx.x * (THREADS * V) + threadIdx.x;
  float xv[V], yv[V], zv[V];
  Sum sr[V], si[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int i = i0 + v * THREADS;
    xv[v] = i < n ? x[i] : 0.f;
    yv[v] = i < n ? y[i] : 0.f;
    zv[v] = i < n ? z[i] : 0.f;
  }
  for (int c0 = 0; c0 < m; c0 += CHUNK) {
    const int len = min(CHUNK, m - c0);
    const int padded = (len + GROUP - 1) / GROUP * GROUP;
    for (int j = threadIdx.x; j < padded; j += THREADS)
      ks[j] = j < len ? make_float4(kx[c0 + j], ky[c0 + j], kz[c0 + j],
                                    phi[c0 + j])
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    for (int g = 0; g < padded; g += GROUP) {
      float ar[V], ai[V];
#pragma unroll
      for (int v = 0; v < V; ++v) ar[v] = ai[v] = 0.f;
#pragma unroll 1
      for (int j = g; j < g + GROUP; j += STEP) {
#pragma unroll
        for (int u = 0; u < STEP; ++u) {
          const float4 k = ks[j + u];
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float t =
                fmaf(xv[v], k.x, fmaf(yv[v], k.y, __fmul_rn(zv[v], k.z)));
            const float r = reduce_turns(t);
            float s, c;
            if (POLY_EVERY && (u * V + v) % POLY_EVERY == POLY_EVERY - 1)
              sincos_poly(r, s, c);
            else
              __sincosf(__fmul_rn(TWO_PI, r), &s, &c);
            ar[v] = fmaf(k.w, c, ar[v]);
            ai[v] = fmaf(k.w, s, ai[v]);
          }
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        sr[v].add(ar[v]);
        si[v].add(ai[v]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int i = i0 + v * THREADS;
    if (i < n) {
      qr[i] = sr[v].s;
      qi[i] = si[v].s;
    }
  }
}

}  // namespace

extern "C" int mriq_launch(const void* kx, const void* ky, const void* kz,
                           const void* phi, const void* x, const void* y,
                           const void* z, void* qr, void* qi, int n, int m,
                           void* stream) {
  if (n <= 0) return 0;
  const int tile = THREADS * V;
  const int blocks = (n + tile - 1) / tile;
  mriq_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(kx), static_cast<const float*>(ky),
      static_cast<const float*>(kz), static_cast<const float*>(phi),
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(z), static_cast<float*>(qr),
      static_cast<float*>(qi), n, m);
  return static_cast<int>(cudaGetLastError());
}

RT_ERROR_STRING(mriq)
