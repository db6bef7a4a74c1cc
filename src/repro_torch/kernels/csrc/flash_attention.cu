// flash_attention.cu — blocked online-softmax attention (GQA, causal and/or
// sliding window, scale 1/sqrt(D)) for sm_90a.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention (_attn_kernel),
// the Pallas TPU kernel whose grid walks kv blocks along a sequential axis and
// carries the online-softmax state (m, l, acc) in VMEM scratch.
//
//   q (B,S,Hq,D), k/v (B,T,Hkv,D) in f32 or bf16 -> o (B,S,Hq,D) in q's dtype;
//   q head h reads kv head h / (Hq/Hkv); masked scores are -1e30 (not -inf),
//   so a fully masked leading tile is wiped later by alpha = 0, and the output
//   divides by max(l, 1e-30), as the reference does.
//
// Bound on the H100: at the slice's shape (B=2, S=T=512, Hq=28, Hkv=4, D=128,
// bf16) the causal half of the scores needs 3.8 GFLOP (3.8 us at the 989
// TFLOP/s bf16 tensor-core peak) and the function moves 16.8 MB (5.0 us at
// 3.35 TB/s), so the card's bound is bytes.  This first version computes in
// f32 on the CUDA cores (67 TFLOP/s), so it is bound by its own FMAs.
//
// Design: one block of 256 threads per (64-query tile, q head, batch).  The
// TPU's sequential kv axis becomes a loop inside the block over 64-key tiles;
// tiles the causal or window mask empties are skipped (they would only add
// terms that alpha = 0 wipes).  Q^T, K^T, V and P^T are staged in shared
// memory as f32 (112 KB at D = 128, two blocks per SM).  Each thread owns a
// 4x4 patch of the score tile and a 4x8 patch of acc (rows x head dims);
// the 16 threads that share rows sit in one half-warp, so the row max and
// row sum of the online softmax are half-warp shuffles and (m, l, alpha)
// stay in registers.  Tensor-core mma.sync / wgmma come in a later version.
#include "common.cuh"

namespace {

constexpr int BQ = 64, BK = 64, DMAX = 128, THREADS = 256;
constexpr float NEG_INF = -1e30f;

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o, int S, int Tk,
            int Hq, int Hkv, int D, int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][BQ]
  float* Kt = Qt + D * BQ;                      // [D][BK]
  float* Vs = Kt + D * BK;                      // [BK][D]
  float* Pt = Vs + BK * D;                      // [BK][BQ]

  constexpr int NV = rt::Io<T>::N;
  const int tid = threadIdx.x;
  const int rg = tid / 16, cg = tid % 16;  // rows rg*4.., cols cg*4.. / dims cg*8..
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int vpr = D / NV;  // 16-byte vectors per row
  const bool dims_live = cg * 8 < D;

  // Q tile, transposed; rows past S load as zeros and are never stored
  for (int idx = tid; idx < BQ * vpr; idx += THREADS) {
    const int r = idx % BQ, dv = (idx / BQ) * NV, qi = q0 + r;
    float tmp[NV];
    rt::load_vec<T>(q + ((size_t)(b * S + qi) * Hq + h) * D + dv, qi < S, tmp);
#pragma unroll
    for (int e = 0; e < NV; ++e) Qt[(dv + e) * BQ + r] = tmp[e];
  }

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const int n_kb = (Tk + BK - 1) / BK;
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * BK;
    if (causal && k0 > q0 + BQ - 1) break;                    // all keys after all queries
    if (window && q0 - (k0 + BK - 1) >= window) continue;     // all keys out of the window
    __syncthreads();  // Qt written; the previous tile's readers are done
    for (int idx = tid; idx < BK * vpr; idx += THREADS) {
      const int c = idx % BK, dv = (idx / BK) * NV, kj = k0 + c;
      const size_t off = ((size_t)(b * Tk + kj) * Hkv + hk) * D + dv;
      float tmp[NV];
      rt::load_vec<T>(k + off, kj < Tk, tmp);
#pragma unroll
      for (int e = 0; e < NV; ++e) Kt[(dv + e) * BK + c] = tmp[e];
    }
    for (int idx = tid; idx < BK * vpr; idx += THREADS) {
      const int c = idx / vpr, dv = (idx % vpr) * NV, kj = k0 + c;
      const size_t off = ((size_t)(b * Tk + kj) * Hkv + hk) * D + dv;
      float tmp[NV];
      rt::load_vec<T>(v + off, kj < Tk, tmp);
#pragma unroll
      for (int e = 0; e < NV; ++e) Vs[c * D + dv + e] = tmp[e];
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qa[4], ka[4];
      rt::lds<4>(&Qt[d * BQ + rg * 4], qa);
      rt::lds<4>(&Kt[d * BK + cg * 4], ka);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    float alpha[4], p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + rg * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + cg * 4 + j;
        const bool ok = kpos < Tk && (!causal || kpos <= qpos) &&
                        (!window || qpos - kpos < window);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(s[i][j] - m_new);
        rs += p[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha[i] + rs;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(cg * 4 + j) * BQ + rg * 4]) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

    if (dims_live) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] *= alpha[i];
      for (int c = 0; c < BK; ++c) {
        float pa[4], va[8];
        rt::lds<4>(&Pt[c * BQ + rg * 4], pa);
        rt::lds<8>(&Vs[c * D + cg * 8], va);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pa[i], va[j], acc[i][j]);
      }
    }
  }

  if (dims_live) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + rg * 4 + i;
      if (qi >= S) continue;
      float out[8];
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < 8; ++j) out[j] = acc[i][j] / den;
      rt::store8<T>(o + ((size_t)(b * S + qi) * Hq + h) * D + cg * 8, out);
    }
  }
}

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v, void* o, int B,
                int S, int Tk, int Hq, int Hkv, int D, int causal, int window,
                float scale, cudaStream_t st) {
  const int smem = (2 * D * BQ + BK * D + BK * BQ) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  attn_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, Hq, Hkv, D, causal,
      window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int Tk, int Hq, int Hkv, int D,
                                      int causal, int window, float scale,
                                      int dtype, void* stream) {
  if (D <= 0 || D > DMAX || D % 8 || Hkv <= 0 || Hq % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == rt::kBF16)
    e = run<__nv_bfloat16>(q, k, v, o, B, S, Tk, Hq, Hkv, D, causal, window,
                           scale, st);
  else if (dtype == rt::kF32)
    e = run<float>(q, k, v, o, B, S, Tk, Hq, Hkv, D, causal, window, scale,
                   st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

RT_ERROR_STRING(flash_attention)
