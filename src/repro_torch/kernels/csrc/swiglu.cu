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
// bf16: two tensor-core designs, chosen by the wrapper by T.  Both keep
// the intermediate a = silu(x wg) * (x wi) as a (T, f) bf16 scratch between
// two products: 38.8 MB at T = 1024, written and read in about 23 us
// against the 422 us operation bound.  The TPU kernel kept a in VMEM
// because VMEM is large; nothing in the function needs that, and the split
// removes the cross-block sums.  Ragged edges (T, d, f, and the K-depth up
// to the next tile) are zero-filled by the cp.async copies themselves.
//
//   prefill (large T): bound by operations, so wgmma, the only path to the
//     tensor cores' full rate.  Each product is computed as its transpose,
//     y^T = wo^T a^T and [h | g]^T = [wi | wg]^T x^T, so both operands keep
//     their stored layouts: the weight tile (k rows of 64 weight columns)
//     is wgmma's A operand, M-major (the transpose flag set); the
//     activation rows (K contiguous) are the B operand, K-major.  Both are
//     staged by cp.async with the 128-byte swizzle and read by descriptor.
//     wgmma.m64n128k16: two warpgroups of 64 weight columns over 128
//     tokens a block, K in tiles of 64 (gate: dual, two accumulators
//     sharing the x tile, silu * mul epilogue, a 4-stage ring, one block
//     an SM; down: a 3-stage ring, two blocks an SM, so its 8 x 28 tiles
//     at T = 1024 sit on the card at once).  Tiles load STAGES - 2 ahead,
//     and a tile's products run while the next tile's barrier passes.
//     The output tile goes through shared memory for 16-byte stores.
//     Below the peak: every thread both copies and multiplies (no producer
//     warp, no TMA), and ptxas serializes the down product's wgmmas
//     (C7514, an accumulator read inside the pipeline; not located yet).
//   decode (small T): bound by the weight stream.  mma.sync.m16n8k16 with x
//     as the A operand in tiles of 32 rows (the idle rows cost tensor-core
//     time that the byte bound leaves free) and 64 x 64 weight tiles
//     through a 4-stage cp.async ring (rows padded by 16 bytes: ldmatrix
//     without bank conflicts).  The K-depth of each product is split
//     across blocks (about 8 waves of blocks over 132 SMs), each split
//     writes f32 partial sums to scratch, and a small kernel adds the
//     splits in a fixed order: gate partials -> a (with silu), down
//     partials -> y.  No atomics: a run repeats bit for bit.
//
// f32: the CUDA-core kernel below (first version), unchanged.  The ff axis
// is split across blocks: block (token tile, ff tile of 128) computes its
// gated tile a = silu(x wg) * (x wi) (BT x 128, f32) from 32-row chunks of
// x, wi and wg staged in shared memory, multiplies it by its 128-row panel
// of wo in 64-column chunks, and adds the partial product into a zeroed
// (T, d) f32 buffer with f32 atomicAdd; a second small kernel casts that
// buffer to y's dtype.  Token tiles are 8 rows for T <= 32 and 64 rows
// otherwise.  Its atomics add in no fixed order: results vary run to run
// by f32 rounding of the partial sums.
#include "mma.cuh"

namespace {

// ---- f32: CUDA cores (first version) --------------------------------------

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
  rt::note_smem(smem);
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


// ---- bf16: tensor-core GEMMs ---------------------------------------------

using bf16 = __nv_bfloat16;

// what a prefill GEMM block does with its accumulators
enum Epi : int {
  kGate = 0,   // a = silu(acc[1]) * acc[0], bf16 (dual GEMM)
  kStore = 1,  // acc, bf16
};

template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_,
          bool DUAL_, int MIN_BLOCKS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr bool DUAL = DUAL_;
  static constexpr int NB = DUAL ? 2 : 1;             // B operands
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int MT = BM / WM / 16, NT = BN / WN / 8;  // a warp's
  static constexpr int LDA = BK + 8, LDB = BN + 8;    // padded rows (bf16)
  static constexpr int STAGE = BM * LDA + NB * BK * LDB;
  static constexpr int SMEM = STAGES * STAGE * 2;
  static_assert(MT * 16 * WM == BM && NT * 8 * WN == BN && NT % 2 == 0 &&
                    BK % 16 == 0 && STAGES >= 2,
                "tile shape");
};

__device__ __forceinline__ float silu(float g) {
  return g * (1.f / (1.f + expf(-g)));
}

// Decode: C = A (M x K, row-major) @ B (K x N, row-major) over the K split
// blockIdx.z * kc .. + kc, written as f32 partial sums to scratch; with
// DUAL, a second B1 shares the A tile.
template <class G>
__global__ void __launch_bounds__(G::THREADS, G::MIN_BLOCKS)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B0,
            const bf16* __restrict__ B1, int M, int N, int K, int kc,
            float* __restrict__ ws) {
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / G::WN, wn = warp % G::WN;
  const int m0 = blockIdx.x * G::BM, n0 = blockIdx.y * G::BN;
  const int kbeg = blockIdx.z * kc, kend = min(K, kbeg + kc);
  const int ntiles = (kend - kbeg + G::BK - 1) / G::BK;

  auto load = [&](int stage, int kt) {
    bf16* sa = smem + stage * G::STAGE;
    bf16* sb = sa + G::BM * G::LDA;
    const int k0 = kbeg + kt * G::BK;
    constexpr int ACH = G::BK / 8, BCH = G::BN / 8;  // 16-byte chunks a row
#pragma unroll
    for (int i = tid; i < G::BM * ACH; i += G::THREADS) {
      const int r = i / ACH, c = (i % ACH) * 8;
      const bool ok = m0 + r < M && k0 + c < kend;
      tc::cp_async16(sa + r * G::LDA + c,
                     ok ? A + (size_t)(m0 + r) * K + k0 + c : A, ok);
    }
#pragma unroll
    for (int i = tid; i < G::BK * BCH; i += G::THREADS) {
      const int r = i / BCH, c = (i % BCH) * 8;
      const bool ok = k0 + r < kend && n0 + c < N;
      const size_t off = (size_t)(k0 + r) * N + n0 + c;
      tc::cp_async16(sb + r * G::LDB + c, ok ? B0 + off : B0, ok);
      if constexpr (G::DUAL)
        tc::cp_async16(sb + (G::BK + r) * G::LDB + c, ok ? B1 + off : B1, ok);
    }
  };

  float acc[G::NB][G::MT][G::NT][4];
#pragma unroll
  for (int b = 0; b < G::NB; ++b)
#pragma unroll
    for (int i = 0; i < G::MT; ++i)
#pragma unroll
      for (int j = 0; j < G::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[b][i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) {
    if (s < ntiles) load(s, s);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < ntiles; ++kt) {
    tc::cp_async_wait<G::STAGES - 2>();  // tile kt has landed
    __syncthreads();                      // ... for every thread; and the
                                          // stage refilled below is free
    const int nk = kt + G::STAGES - 1;
    if (nk < ntiles) load(nk % G::STAGES, nk);
    tc::cp_async_commit();
    const bf16* sa = smem + (kt % G::STAGES) * G::STAGE;
    const bf16* sb = sa + G::BM * G::LDA;
#pragma unroll
    for (int kk = 0; kk < G::BK; kk += 16) {
      uint32_t af[G::MT][4];
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt)
        tc::ldsm_x4(af[mt], sa + ((wm * G::MT + mt) * 16 + (lane & 15)) *
                                     G::LDA + kk + (lane >> 4) * 8);
#pragma unroll
      for (int b = 0; b < G::NB; ++b) {
#pragma unroll
        for (int np = 0; np < G::NT / 2; ++np) {
          uint32_t bf[4];  // b0, b1 of n tile 2np; b0, b1 of 2np + 1
          tc::ldsm_x4_t(bf, sb + (b * G::BK + kk + ((lane >> 3) & 1) * 8 +
                                  (lane & 7)) * G::LDB +
                                (wn * G::NT + 2 * np) * 8 + (lane >> 4) * 8);
#pragma unroll
          for (int mt = 0; mt < G::MT; ++mt) {
            tc::mma16816(acc[b][mt][2 * np], af[mt], bf[0], bf[1]);
            tc::mma16816(acc[b][mt][2 * np + 1], af[mt], bf[2], bf[3]);
          }
        }
      }
    }
  }

  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = m0 + (wm * G::MT + mt) * 16 + g + hf * 8;
        const int c = n0 + (wn * G::NT + nt) * 8 + 2 * t4;
        if (r >= M || c >= N) continue;  // N % 8 == 0: c + 1 < N too
#pragma unroll
        for (int b = 0; b < G::NB; ++b)
          *reinterpret_cast<float2*>(
              ws + ((size_t)(blockIdx.z * G::NB + b) * M + r) * N + c) =
              make_float2(acc[b][mt][nt][2 * hf], acc[b][mt][nt][2 * hf + 1]);
      }
}

// Prefill: out (N x M, row-major) = X (N x K) @ W (K x M), computed as its
// transpose out^T = W^T X^T so that both operands keep the layouts they are
// stored in: W^T, the weight, is wgmma's A operand M-major (a tile row is
// one k, 64 weight columns); X^T is the B operand K-major (a tile row is
// one token, 64 k).  Both are staged with the 128-byte swizzle and read by
// descriptor.  A block holds a 128 (M) x 128 (N) tile: two warpgroups of
// 64 weight columns over 128 tokens; K in tiles of 64 through a cp.async
// ring.  With DUAL a second weight W1 shares the X tile (two accumulators).
template <bool DUAL_, int STAGES_, int MIN_BLOCKS_>
struct WgTile {
  static constexpr bool DUAL = DUAL_;
  static constexpr int STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int BM = 128, BN = 128, BK = 64, THREADS = 256;
  static constexpr int NB = DUAL ? 2 : 1;
  static constexpr int X_BYTES = BN * BK * 2;  // 128 token rows
  static constexpr int W_BYTES = BM * BK * 2;  // two 64-column halves of
                                               // 64 k rows each
  static constexpr int STAGE = X_BYTES + NB * W_BYTES;
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + alignment slack
  static_assert(STAGES >= 3, "tiles load STAGES - 2 ahead");
  static_assert(BN * (BM + 8) * 2 <= STAGES * STAGE, "output tile fits");
};

template <class G, int EPI>
__global__ void __launch_bounds__(G::THREADS, G::MIN_BLOCKS)
wgmma_gemm_kernel(const bf16* __restrict__ X, const bf16* __restrict__ W0,
                  const bf16* __restrict__ W1, int N, int M, int K,
                  bf16* __restrict__ out) {
  extern __shared__ float4 smem4[];
  uint8_t* base = reinterpret_cast<uint8_t*>(smem4);
  base += (1024 - (tc::smem_u32(base) & 1023)) & 1023;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wgp = warp >> 2;  // warpgroup: weight columns 64 wgp ..
  const int n0 = blockIdx.x * G::BN, m0 = blockIdx.y * G::BM;
  const int ntiles = (K + G::BK - 1) / G::BK;

  auto load = [&](int stage, int kt) {
    uint8_t* st = base + stage * G::STAGE;
    const int k0 = kt * G::BK;
#pragma unroll
    for (int i = tid; i < G::BN * (G::BK / 8); i += G::THREADS) {
      const int r = i / (G::BK / 8), c = (i % (G::BK / 8)) * 8;
      const bool ok = n0 + r < N && k0 + c < K;
      tc::cp_async16(st + tc::sw128_offset(r, c),
                     ok ? X + (size_t)(n0 + r) * K + k0 + c : X, ok);
    }
#pragma unroll
    for (int i = tid; i < G::BK * (G::BM / 8); i += G::THREADS) {
      const int r = i / (G::BM / 8), c = (i % (G::BM / 8)) * 8;
      const bool ok = k0 + r < K && m0 + c < M;
      const size_t off = (size_t)(k0 + r) * M + m0 + c;
      const int dst = G::X_BYTES + (c / 64) * (G::BK * 128) +
                      tc::sw128_offset(r, c % 64);
      tc::cp_async16(st + dst, ok ? W0 + off : W0, ok);
      if constexpr (G::DUAL)
        tc::cp_async16(st + G::W_BYTES + dst, ok ? W1 + off : W1, ok);
    }
  };

  float acc[G::NB][64];
#pragma unroll
  for (int b = 0; b < G::NB; ++b)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[b][i] = 0.f;

  // Tiles load STAGES - 2 ahead.  The products of tile kt run while the
  // block passes tile kt + 1's barrier; each thread waits for group kt - 1
  // after issuing group kt, so at the barrier of tile kt + 1 every product
  // that read the stage refilled there (tile kt - 1's) is done.
#pragma unroll
  for (int s = 0; s < G::STAGES - 2; ++s) {
    if (s < ntiles) load(s, s);
    tc::cp_async_commit();
  }
  // only the products touch the accumulators between here and the last
  // wait (any other access would serialize them)
#pragma unroll
  for (int b = 0; b < G::NB; ++b) tc::fence_regs(acc[b]);
  for (int kt = 0; kt < ntiles; ++kt) {
    tc::cp_async_wait<G::STAGES - 3>();  // tile kt has landed
    __syncthreads();
    const int nk = kt + G::STAGES - 2;
    if (nk < ntiles) load(nk % G::STAGES, nk);
    tc::cp_async_commit();
    const uint8_t* st = base + (kt % G::STAGES) * G::STAGE;
    const uint64_t dx = tc::desc_sw128(st);
    const uint64_t dw = tc::desc_sw128(st + G::X_BYTES + wgp * G::BK * 128);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < G::BK / 16; ++kk)
#pragma unroll
      for (int b = 0; b < G::NB; ++b)
        tc::wgmma_m64n128k16_ss(acc[b], dw + b * (G::W_BYTES >> 4) + kk * 128,
                                dx + 2 * kk);
    tc::wgmma_commit();
    tc::wgmma_wait<1>();  // group kt - 1 is done
  }
  tc::wgmma_wait<0>();
#pragma unroll
  for (int b = 0; b < G::NB; ++b) tc::fence_regs(acc[b]);

  // the (tokens x weight cols) tile through shared memory, for 16-byte
  // stores along M
  tc::cp_async_wait<0>();
  __syncthreads();
  constexpr int LDO = G::BM + 8;
  bf16* o = reinterpret_cast<bf16*>(base);
  const int mrow = wgp * 64 + (warp & 3) * 16;  // this warp's 16 columns
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = mrow + g + (e >> 1) * 8;   // weight column in the tile
      const int row = j * 8 + 2 * t4 + (e & 1);  // token in the tile
      float val = acc[0][4 * j + e];
      if constexpr (EPI == kGate) val *= silu(acc[G::NB - 1][4 * j + e]);
      o[row * LDO + col] = __float2bfloat16_rn(val);
    }
  __syncthreads();
#pragma unroll
  for (int i = tid; i < G::BN * (G::BM / 8); i += G::THREADS) {
    const int r = i / (G::BM / 8), c = (i % (G::BM / 8)) * 8;
    if (n0 + r < N && m0 + c < M)
      *reinterpret_cast<uint4*>(out + (size_t)(n0 + r) * M + m0 + c) =
          *reinterpret_cast<const uint4*>(o + r * LDO + c);
  }
}

// Adds the Z K-split partials of an (M x N) product in split order (a fixed
// order: the sum repeats bit for bit) and writes bf16: silu(g) * h for the
// dual gate product, the sum itself for the down product.
template <bool DUAL>
__global__ void combine_kernel(const float* __restrict__ ws, int Z, size_t MN,
                               bf16* __restrict__ out) {
  constexpr int NB = DUAL ? 2 : 1;
  for (size_t i = (blockIdx.x * (size_t)blockDim.x + threadIdx.x) * 4; i < MN;
       i += (size_t)gridDim.x * blockDim.x * 4) {
    float h[4] = {0.f, 0.f, 0.f, 0.f}, gt[4] = {0.f, 0.f, 0.f, 0.f};
    for (int z = 0; z < Z; ++z) {
      const float4 p =
          *reinterpret_cast<const float4*>(ws + (size_t)z * NB * MN + i);
      h[0] += p.x; h[1] += p.y; h[2] += p.z; h[3] += p.w;
      if constexpr (DUAL) {
        const float4 q = *reinterpret_cast<const float4*>(
            ws + ((size_t)z * NB + 1) * MN + i);
        gt[0] += q.x; gt[1] += q.y; gt[2] += q.z; gt[3] += q.w;
      }
    }
    if constexpr (DUAL) {
#pragma unroll
      for (int e = 0; e < 4; ++e) h[e] *= silu(gt[e]);
    }
    *reinterpret_cast<uint2*>(out + i) =
        make_uint2(tc::pack_bf16(h[0], h[1]), tc::pack_bf16(h[2], h[3]));
  }
}

template <class G>
cudaError_t gemm(const bf16* A, const bf16* B0, const bf16* B1, int M, int N,
                 int K, int kc, float* ws, cudaStream_t st) {
  auto kern = gemm_kernel<G>;
  rt::note_smem(G::SMEM);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + G::BM - 1) / G::BM, (N + G::BN - 1) / G::BN,
                  (K + kc - 1) / kc);
  kern<<<grid, G::THREADS, G::SMEM, st>>>(A, B0, B1, M, N, K, kc, ws);
  return cudaGetLastError();
}

template <class G, int EPI>
cudaError_t wgmma_gemm(const bf16* X, const bf16* W0, const bf16* W1, int N,
                       int M, int K, bf16* out, cudaStream_t st) {
  auto kern = wgmma_gemm_kernel<G, EPI>;
  rt::note_smem(G::SMEM);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + G::BN - 1) / G::BN, (M + G::BM - 1) / G::BM);
  kern<<<grid, G::THREADS, G::SMEM, st>>>(X, W0, W1, N, M, K, out);
  return cudaGetLastError();
}

template <bool DUAL>
cudaError_t combine(const float* ws, int Z, size_t MN, bf16* out,
                    cudaStream_t st) {
  const size_t blocks = (MN / 4 + 255) / 256;
  combine_kernel<DUAL><<<(int)(blocks < 1024 ? blocks : 1024), 256, 0, st>>>(
      ws, Z, MN, out);
  return cudaGetLastError();
}

//                 BM  BN  BK WM WN stages dual  blocks/SM
using DecodeGate = Tile<32, 64, 64, 1, 4, 4, true, 2>;
using DecodeDown = Tile<32, 64, 64, 1, 4, 4, false, 3>;
//                    dual stages blocks/SM
using PrefillGate = WgTile<true, 4, 1>;   // 193 KB
using PrefillDown = WgTile<false, 3, 2>;  // 97 KB

// design codes passed by the wrapper
enum Design : int { kF32CudaCores = 0, kBF16Decode = 1, kBF16Prefill = 2 };

cudaError_t run_bf16(int design, const bf16* x, const bf16* wi,
                     const bf16* wg, const bf16* wo, float* ws, bf16* a,
                     bf16* y, int Tn, int d, int f, int kc1, int kc2,
                     cudaStream_t st) {
  cudaError_t e;
  if (design == kBF16Prefill) {
    e = wgmma_gemm<PrefillGate, kGate>(x, wi, wg, Tn, f, d, a, st);
    if (e != cudaSuccess) return e;
    return wgmma_gemm<PrefillDown, kStore>(a, wo, nullptr, Tn, d, f, y, st);
  }
  // decode: K-split partials -> fixed-order sums
  if (kc1 <= 0 || kc1 % 8 || kc2 <= 0 || kc2 % 8) return cudaErrorInvalidValue;
  const int z1 = (d + kc1 - 1) / kc1, z2 = (f + kc2 - 1) / kc2;
  float* ws2 = ws + (size_t)z1 * 2 * Tn * f;
  e = gemm<DecodeGate>(x, wi, wg, Tn, f, d, kc1, ws, st);
  if (e != cudaSuccess) return e;
  e = combine<true>(ws, z1, (size_t)Tn * f, a, st);
  if (e != cudaSuccess) return e;
  e = gemm<DecodeDown>(a, wo, nullptr, Tn, d, f, kc2, ws2, st);
  if (e != cudaSuccess) return e;
  return combine<false>(ws2, z2, (size_t)Tn * d, y, st);
}

}  // namespace

// ws: f32 scratch (f32: the (T, d) sum buffer; bf16 decode: the K-split
// partials, z1 * 2 * T * f then z2 * T * d); a: the (T, f) bf16
// intermediate of the bf16 designs; kc1, kc2: rows of d and of f per K
// split (bf16 decode).
extern "C" int swiglu_launch(const void* x, const void* wi, const void* wg,
                             const void* wo, void* ws, void* a, void* y,
                             int Tn, int d, int f, int design, int kc1,
                             int kc2, void* stream) {
  rt::smem_requested() = 0;
  if (d <= 0 || f <= 0 || d % 8 || f % 8 || Tn < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Tn == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (design == kF32CudaCores)
    e = dispatch<float>(x, wi, wg, wo, static_cast<float*>(ws), y, Tn, d, f,
                        st);
  else if (design == kBF16Decode || design == kBF16Prefill)
    e = run_bf16(design, static_cast<const bf16*>(x),
                 static_cast<const bf16*>(wi), static_cast<const bf16*>(wg),
                 static_cast<const bf16*>(wo), static_cast<float*>(ws),
                 static_cast<bf16*>(a), static_cast<bf16*>(y), Tn, d, f, kc1,
                 kc2, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

RT_ERROR_STRING(swiglu)
RT_REQUESTED_SMEM(swiglu)
