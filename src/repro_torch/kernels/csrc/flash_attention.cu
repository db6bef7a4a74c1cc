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
// Bound on the H100: at qwen2-7b's shape (B=2, S=T=512, Hq=28, Hkv=4, D=128,
// bf16) the causal half of the scores needs 3.8 GFLOP (3.8 us at the 989
// TFLOP/s bf16 tensor-core peak) and the function moves 16.8 MB (5.0 us at
// 3.35 TB/s), so the card's bound is bytes.  At recurrentgemma-9b's local
// attention (B=2, S=T=2560, Hq=16, Hkv=1, D=256, bf16, causal, window 2048)
// the mask keeps 3.1 M (q, k) pairs per head: 103 GFLOP (104 us at the bf16
// peak) against 89 MB moved (27 us), so there the bound is operations.
//
// bf16: FlashAttention-2 on the tensor cores.  One block per (q tile, q head,
// batch), 16 query rows a warp: 4 warps (64 rows) for D <= 128, 8 warps (128
// rows) for D <= 256; causal q tiles start heaviest first.  The Q tile is
// copied once into shared memory; K and V tiles of 64 keys arrive by cp.async
// in a two-stage ring, the next tile loading while the current one is
// computed.  QK^T and PV are mma.sync.m16n8k16 (bf16 -> f32) with ldmatrix
// fragments (.trans for V); the scores stay in registers, the row max and row
// sum are quad shuffles in the mma fragment layout, and P is rounded to bf16
// in registers and fed as the A operand of PV (the C layout of two key tiles
// is the A layout of one k16 step), never through shared memory.  Head dims
// that are not a multiple of 16 are zero-padded to 16 in shared memory by the
// copies; rows past S and T are zero-filled and masked.  Key tiles that the
// causal or window mask empties for the whole q tile are skipped.  At D = 256
// a thread holds 128 f32 of O; Q and two stages of K and V take 198 KB, one
// block an SM.  mma.sync, not wgmma: attention at these shapes is 3.8-103
// GFLOP, and closing the gap to the library does not need the last factor that
// wgmma and warp specialisation give (a FlashAttention-3 kernel, TMA and
// wgmma, is a later version).  The one rounding this adds against the
// reference, P to bf16 before PV, is the one the library's kernels make.
//
// f32: the CUDA-core kernel below (first version), unchanged: one block of
// 256 threads per (64-query tile, q head, batch), Q^T, K^T, V and P^T staged
// in shared memory as f32, each thread a 4x4 patch of the score tile and a
// 4xDV patch of acc; DV = 8 for D <= 128 and 16 for D <= 256.
#include "mma.cuh"

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 256;
constexpr float NEG_INF = -1e30f;

// DV head dims per thread: 16 threads cover D <= 16 * DV
template <typename T, int DV>
__global__ void __launch_bounds__(THREADS, DV == 8 ? 2 : 1)
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
  const int rg = tid / 16, cg = tid % 16;  // rows rg*4.., cols cg*4.. / dims cg*DV..
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int vpr = D / NV;  // 16-byte vectors per row
  const bool dims_live = cg * DV < D;

  // Q tile, transposed; rows past S load as zeros and are never stored
  for (int idx = tid; idx < BQ * vpr; idx += THREADS) {
    const int r = idx % BQ, dv = (idx / BQ) * NV, qi = q0 + r;
    float tmp[NV];
    rt::load_vec<T>(q + ((size_t)(b * S + qi) * Hq + h) * D + dv, qi < S, tmp);
#pragma unroll
    for (int e = 0; e < NV; ++e) Qt[(dv + e) * BQ + r] = tmp[e];
  }

  float m[4], l[4], acc[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DV; ++j) acc[i][j] = 0.f;
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
        for (int j = 0; j < DV; ++j) acc[i][j] *= alpha[i];
      for (int c = 0; c < BK; ++c) {
        float pa[4], va[DV];
        rt::lds<4>(&Pt[c * BQ + rg * 4], pa);
        rt::lds<DV>(&Vs[c * D + cg * DV], va);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DV; ++j) acc[i][j] = fmaf(pa[i], va[j], acc[i][j]);
      }
    }
  }

  if (dims_live) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + rg * 4 + i;
      if (qi >= S) continue;
      float out[DV];
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < DV; ++j) out[j] = acc[i][j] / den;
      T* dst = o + ((size_t)(b * S + qi) * Hq + h) * D + cg * DV;
#pragma unroll
      for (int j = 0; j < DV; j += 8) rt::store8<T>(dst + j, out + j);
    }
  }
}

template <typename T, int DV>
cudaError_t run(const void* q, const void* k, const void* v, void* o, int B,
                int S, int Tk, int Hq, int Hkv, int D, int causal, int window,
                float scale, cudaStream_t st) {
  const int smem = (2 * D * BQ + BK * D + BK * BQ) * (int)sizeof(float);
  rt::note_smem(smem);
  cudaError_t e = cudaFuncSetAttribute(
      attn_kernel<T, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  attn_kernel<T, DV><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, Hq, Hkv, D, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_d(const void* q, const void* k, const void* v, void* o, int B,
                  int S, int Tk, int Hq, int Hkv, int D, int causal,
                  int window, float scale, cudaStream_t st) {
  if (D <= 128)
    return run<T, 8>(q, k, v, o, B, S, Tk, Hq, Hkv, D, causal, window, scale,
                     st);
  return run<T, 16>(q, k, v, o, B, S, Tk, Hq, Hkv, D, causal, window, scale,
                    st);
}

// ---- bf16: tensor cores ---------------------------------------------------

using bf16 = __nv_bfloat16;

// DMAX: the largest head dim of the instance (128 or 256); WARPS warps of
// 16 query rows each.  Q, K and V rows are DMAX + 8 bf16 apart in shared
// memory (a 16-byte pad: ldmatrix rows fall in distinct bank groups).
template <int DMAX, int WARPS>
struct AttnTile {
  static constexpr int BQ = 16 * WARPS, BK = 64, THREADS = 32 * WARPS;
  static constexpr int LD = DMAX + 8;
  static constexpr int SMEM = (BQ + 4 * BK) * LD * 2;  // Q + 2 stages of K, V
};

template <int DMAX, int WARPS>
__global__ void __launch_bounds__(32 * WARPS, DMAX <= 128 ? 2 : 1)
attn_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, int S,
               int Tk, int Hq, int Hkv, int D, int causal, int window,
               float scale) {
  using A = AttnTile<DMAX, WARPS>;
  constexpr int BQ = A::BQ, BK = A::BK, LD = A::LD;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);  // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                    // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                // [2][BK][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  // causal: the q tiles with the most key tiles start first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int DP = (D + 15) & ~15;  // K-depth of QK^T padded to 16 (zeros)
  const int nch = DP / 8;         // 16-byte chunks a row; those past D zero

  for (int i = tid; i < BQ * nch; i += A::THREADS) {
    const int r = i / nch, c = (i % nch) * 8, qi = q0 + r;
    const bool ok = qi < S && c < D;
    tc::cp_async16(Qs + r * LD + c,
                   ok ? q + ((size_t)(b * S + qi) * Hq + h) * D + c : q, ok);
  }
  tc::cp_async_commit();

  auto load_kv = [&](int stage, int kb) {
    const int k0 = kb * BK;
    bf16* ks = Ks + stage * BK * LD;
    bf16* vs = Vs + stage * BK * LD;
    for (int i = tid; i < BK * nch; i += A::THREADS) {
      const int r = i / nch, c = (i % nch) * 8, kj = k0 + r;
      const bool ok = kj < Tk && c < D;  // rows past Tk load as zeros
      const size_t off = ((size_t)(b * Tk + kj) * Hkv + hk) * D + c;
      tc::cp_async16(ks + r * LD + c, ok ? k + off : k, ok);
      tc::cp_async16(vs + r * LD + c, ok ? v + off : v, ok);
    }
  };

  // the key tiles that the causal and window masks leave for this q tile:
  // a contiguous range (the skipped tiles would add only terms that
  // alpha = 0 wipes)
  const int n_kb = (Tk + BK - 1) / BK;
  const int kb_hi = causal ? min(n_kb, (q0 + BQ - 1) / BK + 1) : n_kb;
  const int lo = q0 - window - BK + 1;  // tiles with k0 <= lo are all
  const int kb_lo = window && lo >= 0 ? lo / BK + 1 : 0;  // out of the window

  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};  // rows g, g + 8
  float oacc[DMAX / 8][4];
#pragma unroll
  for (int nt = 0; nt < DMAX / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[nt][e] = 0.f;

  if (kb_lo < kb_hi) load_kv(0, kb_lo);
  tc::cp_async_commit();
  const int qrow = q0 + warp * 16 + g;  // this thread's rows: qrow, qrow + 8
  const bf16* qw = Qs + warp * 16 * LD;
  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int stage = (kb - kb_lo) & 1;
    tc::cp_async_wait<0>();  // Q and this tile have landed
    __syncthreads();         // ... for all; the other stage is free
    if (kb + 1 < kb_hi) load_kv(stage ^ 1, kb + 1);
    tc::cp_async_commit();
    const bf16* ks = Ks + stage * BK * LD;
    const bf16* vs = Vs + stage * BK * LD;

    // S = Q K^T: 16 rows x 64 keys a warp, in registers
    float sc[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if (kk * 16 >= DP) break;
      uint32_t a[4];
      tc::ldsm_x4(a, qw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t kf[4];  // b0, b1 of key tile 2np; b0, b1 of 2np + 1
        tc::ldsm_x4(kf, ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        tc::mma16816(sc[2 * np], a, kf[0], kf[1]);
        tc::mma16816(sc[2 * np + 1], a, kf[2], kf[3]);
      }
    }

    // online softmax; a row's 64 scores sit in the 4 threads of a quad
    const int k0 = kb * BK;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = qrow + (e >> 1) * 8;
        const int kpos = k0 + nt * 8 + 2 * t4 + (e & 1);
        const bool ok = kpos < Tk && (!causal || kpos <= qpos) &&
                        (!window || qpos - kpos < window);
        sc[nt][e] = ok ? sc[nt][e] * scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      alpha[i] = exp2f((m_r[i] - m_new) * LOG2E);
      m_r[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nt][e] = exp2f((sc[nt][e] - m_r[e >> 1]) * LOG2E);
        rs[e >> 1] += sc[nt][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)  // each thread's share of the quad's sum
      l_r[i] = l_r[i] * alpha[i] + rs[i];
#pragma unroll
    for (int nt = 0; nt < DMAX / 8; ++nt) {
      oacc[nt][0] *= alpha[0];
      oacc[nt][1] *= alpha[0];
      oacc[nt][2] *= alpha[1];
      oacc[nt][3] *= alpha[1];
    }

    // O += P V: the score fragments, rounded to bf16 in registers, are the
    // A operand (the C layout of two key tiles is the A layout of one k16)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const float(&p0)[4] = sc[2 * kk], (&p1)[4] = sc[2 * kk + 1];
      const uint32_t pa[4] = {
          tc::pack_bf16(p0[0], p0[1]), tc::pack_bf16(p0[2], p0[3]),
          tc::pack_bf16(p1[0], p1[1]), tc::pack_bf16(p1[2], p1[3])};
#pragma unroll
      for (int np = 0; np < DMAX / 16; ++np) {
        if (np * 16 >= DP) break;
        uint32_t vf[4];  // b0, b1 of dim tile 2np; b0, b1 of 2np + 1
        tc::ldsm_x4_t(vf, vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                   LD + np * 16 + (lane >> 4) * 8);
        tc::mma16816(oacc[2 * np], pa, vf[0], vf[1]);
        tc::mma16816(oacc[2 * np + 1], pa, vf[2], vf[3]);
      }
    }
  }

  // O / max(l, 1e-30) in bf16, staged through this warp's own Q rows for
  // 16-byte stores
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    inv[i] = 1.f / fmaxf(l_r[i], 1e-30f);
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // every thread's copies into Q have landed
  bf16* ow = Qs + warp * 16 * LD;
#pragma unroll
  for (int nt = 0; nt < DMAX / 8; ++nt) {
    if (nt * 8 >= DP) break;
    *reinterpret_cast<uint32_t*>(ow + g * LD + nt * 8 + 2 * t4) =
        tc::pack_bf16(oacc[nt][0] * inv[0], oacc[nt][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(ow + (g + 8) * LD + nt * 8 + 2 * t4) =
        tc::pack_bf16(oacc[nt][2] * inv[1], oacc[nt][3] * inv[1]);
  }
  __syncwarp();
  const int dch = D / 8;
  for (int i = lane; i < 16 * dch; i += 32) {
    const int r = i / dch, c = (i % dch) * 8, qi = q0 + warp * 16 + r;
    if (qi < S)
      *reinterpret_cast<uint4*>(o + ((size_t)(b * S + qi) * Hq + h) * D + c) =
          *reinterpret_cast<const uint4*>(ow + r * LD + c);
  }
}

template <int DMAX, int WARPS>
cudaError_t run_tc(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Tk, int Hq, int Hkv, int D, int causal,
                   int window, float scale, cudaStream_t st) {
  using A = AttnTile<DMAX, WARPS>;
  auto kern = attn_tc_kernel<DMAX, WARPS>;
  rt::note_smem(A::SMEM);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, A::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + A::BQ - 1) / A::BQ, Hq, B);
  kern<<<grid, A::THREADS, A::SMEM, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, Tk, Hq, Hkv, D,
      causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int Tk, int Hq, int Hkv, int D,
                                      int causal, int window, float scale,
                                      int dtype, void* stream) {
  rt::smem_requested() = 0;
  if (D <= 0 || D % 8 || D > 256 || (D > 128 && D % 16) || Hkv <= 0 ||
      Hq % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == rt::kBF16)  // 64 queries a block at D <= 128 (85 KB, two
                           // blocks an SM), 128 at D <= 256 (198 KB)
    e = D <= 128 ? run_tc<128, 4>(q, k, v, o, B, S, Tk, Hq, Hkv, D, causal,
                                  window, scale, st)
                 : run_tc<256, 8>(q, k, v, o, B, S, Tk, Hq, Hkv, D, causal,
                                  window, scale, st);
  else if (dtype == rt::kF32)
    e = run_d<float>(q, k, v, o, B, S, Tk, Hq, Hkv, D, causal, window, scale,
                     st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

RT_ERROR_STRING(flash_attention)
RT_REQUESTED_SMEM(flash_attention)
