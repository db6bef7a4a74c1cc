// ssd.cu — the Mamba2 SSD chunked scan (state-space duality) for sm_90a.
//
// Replaces src/repro/kernels/ssd.py:ssd_pallas (_ssd_kernel), the Pallas TPU
// kernel whose grid walks the chunks of one (batch, head) along a sequential
// axis and carries the (P, N) state in VMEM scratch.
//
//   x (B,S,H,P) and B/C (B,S,N) in f32 or bf16, dt (B,S,H) f32, A (H,) f32
//   -> y (B,S,H,P) in x's dtype and the final state (B,H,P,N) in f32.
//   Per (b, h), chunks of Q positions in order, with cum = cumsum(dt·A) over
//   the chunk:
//     y     = (C Bᵀ ⊙ L) @ xd + exp(cum) ⊙ (C @ stateᵀ),  L_ij = exp(cum_i − cum_j), i ≥ j
//     state ← exp(cum_Q)·state + (xd ⊙ exp(cum_Q − cum))ᵀ @ B
//   with xd = x·dt.  xd and dt·A are formed here as the tiles load (the
//   reference forms them in f32 before its kernel), so they never reach
//   device memory.
//
// The decay L_ij is exponentiated only where i ≥ j: above the diagonal the
// exponent is positive and, at Q = 256, reaches ~200, past f32's 88 — the
// reference's exp-then-mask gives inf there and NaN after the mask
// (ROADMAP.md, fault C1).
//
// Bound on the H100: at mamba2-1.3b's prefill shape (B=2, S=512, H=64, P=64,
// N=128, Q=256, bf16) the function moves ~22 MB (6.6 us at 3.35 TB/s) and its
// ~5 GFLOP of chunk products would take ~5 us on the bf16 tensor cores, so
// the card's bound is bytes.  This first version computes in f32 on the CUDA
// cores and is bound by its own FMAs and shared-memory reads.
//
// Design: one block of 256 threads per (head, batch) walks the chunks in
// order; the (P, N) state stays in shared memory (32 KB in f32 at P=64,
// N=128) for the whole sequence.  That is B·H = 128 blocks at the prefill
// shape: about one wave on 132 SMs, one block per SM.  A (Q, Q) f32 block
// would be 256 KB at Q = 256, over the 227 KB a block may use, so the chunk
// is tiled in 64-row query tiles against the 64-row key tiles j ≤ i: per
// pair, the 64x64 scores C_i B_jᵀ are masked, decayed and staged in shared
// memory, then multiplied into the query tile's y.  Each thread owns a 4x4
// patch of the scores and 4 rows x up to 8 head dims of y (dims cg + 16k).
// The within-chunk cumsum is a block-wide scan (warp shuffles, then the warp
// totals).  Any chunk length works: rows past the end of a ragged chunk or
// tile load as zeros and are never stored.  A chunk-parallel version (more
// blocks than (b, h) pairs) and tensor-core products come later.
#include "common.cuh"

namespace {

constexpr int THREADS = 256, BT = 64, TS = BT + 4;  // TS: padded row of C/B tiles
constexpr int KMAX = 8, PMAX = 16 * KMAX;           // head dims per thread, at most
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__host__ __device__ constexpr int al4(int n) { return (n + 3) & ~3; }

// Inclusive scan of one value per thread across the block.
__device__ float block_scan(float v, float* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < WARPS ? wsum[lane] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += u;
    }
    if (lane < WARPS) wsum[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += wsum[warp - 1];
  __syncthreads();
  return v;
}

// rows r0.. of a (S,N) matrix (B or C of one batch) -> tile[n * TS + r],
// zeros past row L
template <typename T>
__device__ void load_bc(const T* src, int r0, int L, int N, float* tile) {
  for (int idx = threadIdx.x; idx < BT * N; idx += THREADS) {
    const int r = idx / N, n = idx % N;
    tile[n * TS + r] = r0 + r < L ? ld(src + (size_t)(r0 + r) * N + n) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, T* __restrict__ y,
           float* __restrict__ state_out, int S, int H, int P, int N, int Q) {
  extern __shared__ float4 smem4[];
  float* stT = reinterpret_cast<float*>(smem4);  // [N][P] state, transposed
  float* CsT = stT + al4(N * P);                 // [N][TS] C tile, transposed
  float* BsT = CsT + N * TS;                     // [N][TS] B tile, transposed
  float* Xs = BsT + N * TS;                      // [BT][P] xd tile
  float* SsT = Xs + al4(BT * P);                 // [BT][BT] scores, transposed
  float* cum = SsT + BT * BT;                    // [Q] cumsum of dt·A
  float* wsum = cum + al4(Q);                    // [WARPS] scan scratch

  const int tid = threadIdx.x;
  const int rg = tid / 16, cg = tid % 16;  // rows rg*4.., score cols cg*4.., dims cg+16k
  const int h = blockIdx.x, b = blockIdx.y;
  const float a_h = A[h];
  const T* xb = x + (size_t)b * S * H * P + (size_t)h * P;  // + s*H*P + p
  const float* dtb = dt + (size_t)b * S * H + h;            // + s*H
  const T* Bb = Bm + (size_t)b * S * N;
  const T* Cb = Cm + (size_t)b * S * N;
  T* yb = y + (size_t)b * S * H * P + (size_t)h * P;

  for (int idx = tid; idx < N * P; idx += THREADS) stT[idx] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int L = min(Q, S - c0);
    const int nt = (L + BT - 1) / BT;

    // cum[i] = sum_{j <= i} dt_j·A over the chunk, a block scan per 256 rows
    float carry = 0.f;
    for (int base = 0; base < L; base += THREADS) {
      const int i = base + tid;
      const float v = i < L ? dtb[(size_t)(c0 + i) * H] * a_h : 0.f;
      const float s = block_scan(v, wsum) + carry;
      if (i < L) cum[i] = s;
      __syncthreads();
      carry = cum[min(base + THREADS, L) - 1];
    }
    const float cum_last = cum[L - 1];

    for (int it = 0; it < nt; ++it) {
      const int i0 = it * BT;
      __syncthreads();  // the previous tile's readers of CsT are done
      load_bc<T>(Cb + (size_t)c0 * N, i0, L, N, CsT);
      __syncthreads();

      // the carried state's part: exp(cum_i) · (C_i @ stateᵀ)
      float acc[4][KMAX];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int k = 0; k < KMAX; ++k) acc[ii][k] = 0.f;
      for (int n = 0; n < N; ++n) {
        float c[4];
        rt::lds<4>(&CsT[n * TS + rg * 4], c);
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          const int p = cg + 16 * k;
          if (p < P) {
            const float st = stT[n * P + p];
#pragma unroll
            for (int ii = 0; ii < 4; ++ii) acc[ii][k] = fmaf(c[ii], st, acc[ii][k]);
          }
        }
      }
      float cum_i[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = i0 + rg * 4 + ii;
        cum_i[ii] = i < L ? cum[i] : 0.f;
        const float e = i < L ? expf(cum_i[ii]) : 0.f;
#pragma unroll
        for (int k = 0; k < KMAX; ++k) acc[ii][k] *= e;
      }

      // the chunk's own part: key tiles j <= i
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * BT;
        __syncthreads();  // the previous key tile's readers are done
        load_bc<T>(Bb + (size_t)c0 * N, j0, L, N, BsT);
        for (int idx = tid; idx < BT * P; idx += THREADS) {
          const int j = idx / P, p = idx % P, s = c0 + j0 + j;
          Xs[idx] = j0 + j < L
                        ? ld(xb + (size_t)s * H * P + p) * dtb[(size_t)s * H]
                        : 0.f;
        }
        __syncthreads();

        float sc[4][4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) sc[ii][jj] = 0.f;
        for (int n = 0; n < N; ++n) {
          float c[4], bv[4];
          rt::lds<4>(&CsT[n * TS + rg * 4], c);
          rt::lds<4>(&BsT[n * TS + cg * 4], bv);
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) sc[ii][jj] = fmaf(c[ii], bv[jj], sc[ii][jj]);
        }
        // mask, then decay: never exponentiate above the diagonal
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = j0 + cg * 4 + jj;
          float col[4];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            const int i = i0 + rg * 4 + ii;
            col[ii] = (j <= i && i < L) ? sc[ii][jj] * expf(cum_i[ii] - cum[j]) : 0.f;
          }
          *reinterpret_cast<float4*>(&SsT[(cg * 4 + jj) * BT + rg * 4]) =
              make_float4(col[0], col[1], col[2], col[3]);
        }
        __syncthreads();

        const int jn = min(BT, L - j0);
        for (int j = 0; j < jn; ++j) {
          float s4[4];
          rt::lds<4>(&SsT[j * BT + rg * 4], s4);
#pragma unroll
          for (int k = 0; k < KMAX; ++k) {
            const int p = cg + 16 * k;
            if (p < P) {
              const float xv = Xs[j * P + p];
#pragma unroll
              for (int ii = 0; ii < 4; ++ii) acc[ii][k] = fmaf(s4[ii], xv, acc[ii][k]);
            }
          }
        }
      }

#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = i0 + rg * 4 + ii;
        if (i >= L) continue;
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          const int p = cg + 16 * k;
          if (p < P) yb[(size_t)(c0 + i) * H * P + p] = rt::Io<T>::cvt(acc[ii][k]);
        }
      }
    }

    // state <- exp(cum_Q)·state + (xd ⊙ exp(cum_Q − cum))ᵀ @ B
    __syncthreads();  // every query tile has read the old state
    const float decay = expf(cum_last);
    for (int idx = tid; idx < N * P; idx += THREADS) stT[idx] *= decay;
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * BT;
      __syncthreads();
      load_bc<T>(Bb + (size_t)c0 * N, j0, L, N, BsT);
      for (int idx = tid; idx < BT * P; idx += THREADS) {
        const int j = idx / P, p = idx % P, s = c0 + j0 + j;
        Xs[idx] = j0 + j < L ? ld(xb + (size_t)s * H * P + p) * dtb[(size_t)s * H] *
                                   expf(cum_last - cum[j0 + j])
                             : 0.f;
      }
      __syncthreads();
      const int jn = min(BT, L - j0);
      for (int idx = tid; idx < N * P; idx += THREADS) {
        const int n = idx / P, p = idx % P;
        float s = 0.f;
        for (int j = 0; j < jn; ++j) s = fmaf(BsT[n * TS + j], Xs[j * P + p], s);
        stT[idx] += s;
      }
    }
    __syncthreads();  // the state is whole before the next chunk reads it
  }

  float* so = state_out + ((size_t)b * H + h) * P * N;
  for (int idx = tid; idx < N * P; idx += THREADS) {
    const int p = idx / N, n = idx % N;
    so[idx] = stT[n * P + p];
  }
}

int smem_bytes(int P, int N, int Q) {
  return (al4(N * P) + 2 * N * TS + al4(BT * P) + BT * BT + al4(Q) + WARPS) *
         (int)sizeof(float);
}

template <typename T>
cudaError_t run(const void* x, const void* dt, const void* A, const void* Bm,
                const void* Cm, void* y, void* state, int B, int S, int H,
                int P, int N, int Q, cudaStream_t st) {
  const int smem = smem_bytes(P, N, Q);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(H, B);
  ssd_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y),
      static_cast<float*>(state), S, H, P, N, Q);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ssd_launch(const void* x, const void* dt, const void* A,
                          const void* Bm, const void* Cm, void* y, void* state,
                          int B, int S, int H, int P, int N, int Q, int dtype,
                          void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > PMAX || N <= 0 || Q <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == rt::kBF16)
    e = run<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, B, S, H, P, N, Q, st);
  else if (dtype == rt::kF32)
    e = run<float>(x, dt, A, Bm, Cm, y, state, B, S, H, P, N, Q, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

RT_ERROR_STRING(ssd)
