// swiglu.cu — fused SwiGLU MLP, y = (silu(x @ wg) * (x @ wi)) @ wo, for sm_90a.
//
// Replaces src/repro/kernels/swiglu.py:swiglu_pallas (_swiglu_kernel), the
// Pallas TPU kernel whose grid walks ff blocks along a sequential axis and
// accumulates the second product into a (block_t, d) f32 VMEM tile, so the
// (T, d_ff) intermediate never reaches HBM.
//
//   x (T,d), wi/wg (d,f), wo (f,d) in f32 or bf16 -> y (T,d) in x's dtype.
//
// Bound on the H100 at qwen2-7b's widths (d = 3584, f = 18944, bf16):
//   decode, T = 8:     3.3 GFLOP, 407 MB of weights -> 122 us, bound by bytes;
//   prefill, T = 1024: 417 GFLOP, 422 MB            -> 422 us, bound by
//                      operations at the 989 TFLOP/s tensor-core peak.
//
// Design: the TPU grid is not copied.  Carried over as "one block per token
// tile looping over ff", decode would run on one SM of 132 and stream the
// 407 MB of weights through it.  Instead the ff axis is split across blocks:
// block (token tile, ff tile of 128) computes its gated tile
// a = silu(x wg) * (x wi) (BT x 128, f32) from 32-row chunks of x, wi and wg
// staged in shared memory, keeps it in shared memory, multiplies it by its
// 128-row panel of wo in 64-column chunks, and adds the partial product into
// a zeroed (T, d) f32 buffer with f32 atomicAdd; a second small kernel casts
// that buffer to y's dtype.  The intermediate still never reaches device
// memory; the partial sums do, as f32 atomics (T * d * f/128 of them).
// Token tiles are 8 rows for T <= 32 (decode: 148 blocks cover the 132 SMs
// and each weight byte is read once) and 64 rows otherwise.  All products
// are f32 FMAs on the CUDA cores, so prefill is bound by those FMAs and
// decode by the weight stream; mma.sync / wgmma come in a later version.
// The atomics add in no fixed order: results vary run to run by f32
// rounding of the partial sums.
#include "common.cuh"

namespace {

constexpr int THREADS = 256, BF = 128, DK = 32, DN = 64;

template <typename T, int BT, int TM, int TN, int TM2, int TN2>
__global__ void __launch_bounds__(THREADS)
swiglu_kernel(const T* __restrict__ x, const T* __restrict__ wi,
              const T* __restrict__ wg, const T* __restrict__ wo,
              float* __restrict__ y32, int Tn, int d, int f) {
  static_assert((BT / TM) * (BF / TN) == THREADS, "phase-1 thread map");
  static_assert((BT / TM2) * (DN / TN2) == THREADS, "phase-2 thread map");
  extern __shared__ float4 smem4[];
  float* At = reinterpret_cast<float*>(smem4);  // [BF][BT] gated tile, transposed
  float* xT = At + BF * BT;                     // [DK][BT] phase 1
  float* Wi = xT + DK * BT;                     // [DK][BF] phase 1
  float* Wg = Wi + DK * BF;                     // [DK][BF] phase 1
  float* Wo = xT;                               // [BF][DN] phase 2 (reuses phase 1)

  constexpr int NV = rt::Io<T>::N;
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * BT, f0 = blockIdx.y * BF;

  // ---- phase 1: h = x wi, g = x wg over the block's ff tile ----------------
  constexpr int CG = BF / TN;
  const int rg = tid / CG, cg = tid % CG;
  float hacc[TM][TN], gacc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) hacc[i][j] = gacc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += DK) {
    for (int idx = tid; idx < BT * (DK / NV); idx += THREADS) {
      const int r = idx % BT, kv = (idx / BT) * NV;
      float tmp[NV];
      rt::load_vec<T>(x + (size_t)(t0 + r) * d + k0 + kv,
                      t0 + r < Tn && k0 + kv < d, tmp);
#pragma unroll
      for (int e = 0; e < NV; ++e) xT[(kv + e) * BT + r] = tmp[e];
    }
    for (int idx = tid; idx < DK * (BF / NV); idx += THREADS) {
      const int kr = idx / (BF / NV), cv = (idx % (BF / NV)) * NV;
      const bool ok = k0 + kr < d && f0 + cv < f;
      const size_t off = (size_t)(k0 + kr) * f + f0 + cv;
      float tmp[NV];
      rt::load_vec<T>(wi + off, ok, tmp);
#pragma unroll
      for (int e = 0; e < NV; ++e) Wi[kr * BF + cv + e] = tmp[e];
      rt::load_vec<T>(wg + off, ok, tmp);
#pragma unroll
      for (int e = 0; e < NV; ++e) Wg[kr * BF + cv + e] = tmp[e];
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < DK; ++kk) {
      float xa[TM], wa[TN], ga[TN];
      rt::lds<TM>(&xT[kk * BT + rg * TM], xa);
      rt::lds<TN>(&Wi[kk * BF + cg * TN], wa);
      rt::lds<TN>(&Wg[kk * BF + cg * TN], ga);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          hacc[i][j] = fmaf(xa[i], wa[j], hacc[i][j]);
          gacc[i][j] = fmaf(xa[i], ga[j], gacc[i][j]);
        }
    }
    __syncthreads();
  }
  // a = silu(g) * h = (g * sigmoid(g)) * h; ff columns past f hold zeros
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float g = gacc[i][j];
      At[(cg * TN + j) * BT + rg * TM + i] =
          g * (1.f / (1.f + expf(-g))) * hacc[i][j];
    }
  __syncthreads();

  // ---- phase 2: y[t0:t0+BT, :] += a @ wo[f0:f0+BF, :] ------------------------
  constexpr int CG2 = DN / TN2;
  const int rg2 = tid / CG2, cg2 = tid % CG2;
  for (int n0 = 0; n0 < d; n0 += DN) {
    for (int idx = tid; idx < BF * (DN / NV); idx += THREADS) {
      const int fr = idx / (DN / NV), nv = (idx % (DN / NV)) * NV;
      float tmp[NV];
      rt::load_vec<T>(wo + (size_t)(f0 + fr) * d + n0 + nv,
                      f0 + fr < f && n0 + nv < d, tmp);
#pragma unroll
      for (int e = 0; e < NV; ++e) Wo[fr * DN + nv + e] = tmp[e];
    }
    __syncthreads();
    float acc[TM2][TN2];
#pragma unroll
    for (int i = 0; i < TM2; ++i)
#pragma unroll
      for (int j = 0; j < TN2; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int j = 0; j < BF; ++j) {
      float aa[TM2], wv[TN2];
      rt::lds<TM2>(&At[j * BT + rg2 * TM2], aa);
      rt::lds<TN2>(&Wo[j * DN + cg2 * TN2], wv);
#pragma unroll
      for (int i = 0; i < TM2; ++i)
#pragma unroll
        for (int jj = 0; jj < TN2; ++jj)
          acc[i][jj] = fmaf(aa[i], wv[jj], acc[i][jj]);
    }
#pragma unroll
    for (int i = 0; i < TM2; ++i) {
      const int r = t0 + rg2 * TM2 + i;
      if (r >= Tn) continue;
#pragma unroll
      for (int jj = 0; jj < TN2; ++jj) {
        const int n = n0 + cg2 * TN2 + jj;
        if (n < d) atomicAdd(&y32[(size_t)r * d + n], acc[i][jj]);
      }
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void cast_kernel(const float* __restrict__ y32, T* __restrict__ y,
                            size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    y[i] = rt::Io<T>::cvt(y32[i]);
}

template <typename T, int BT, int TM, int TN, int TM2, int TN2>
cudaError_t run(const void* x, const void* wi, const void* wg, const void* wo,
                float* y32, void* y, int Tn, int d, int f, cudaStream_t st) {
  auto kern = swiglu_kernel<T, BT, TM, TN, TM2, TN2>;
  const int smem = (BF * BT + DK * BT + 2 * DK * BF) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const size_t n = (size_t)Tn * d;
  e = cudaMemsetAsync(y32, 0, n * sizeof(float), st);
  if (e != cudaSuccess) return e;
  const dim3 grid((Tn + BT - 1) / BT, (f + BF - 1) / BF);
  kern<<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wi),
      static_cast<const T*>(wg), static_cast<const T*>(wo), y32, Tn, d, f);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  cast_kernel<T><<<blocks, 256, 0, st>>>(y32, static_cast<T*>(y), n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* wi, const void* wg,
                     const void* wo, float* y32, void* y, int Tn, int d,
                     int f, cudaStream_t st) {
  if (Tn <= 32)  // decode-sized: 8-token tiles, weights streamed once
    return run<T, 8, 1, 4, 1, 2>(x, wi, wg, wo, y32, y, Tn, d, f, st);
  return run<T, 64, 4, 8, 4, 4>(x, wi, wg, wo, y32, y, Tn, d, f, st);
}

}  // namespace

extern "C" int swiglu_launch(const void* x, const void* wi, const void* wg,
                             const void* wo, void* y32, void* y, int Tn,
                             int d, int f, int dtype, void* stream) {
  if (d <= 0 || f <= 0 || d % 8 || f % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Tn == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* acc = static_cast<float*>(y32);
  cudaError_t e;
  if (dtype == rt::kBF16)
    e = dispatch<__nv_bfloat16>(x, wi, wg, wo, acc, y, Tn, d, f, st);
  else if (dtype == rt::kF32)
    e = dispatch<float>(x, wi, wg, wo, acc, y, Tn, d, f, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

RT_ERROR_STRING(swiglu)
