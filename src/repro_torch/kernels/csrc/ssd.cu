// ssd.cu — the Mamba2 SSD chunked scan (state-space duality) for sm_90a.
//
// Replaces src/repro/kernels/ssd.py:ssd_pallas (_ssd_kernel), the Pallas TPU
// kernel whose grid walks the chunks of one (batch, head) along a sequential
// axis and carries the (P, N) state in VMEM scratch.
//
//   x (B,S,H,P) and B/C (B,S,N) in f32 or bf16, dt (B,S,H) f32, A (H,) f32
//   -> y (B,S,H,P) in x's dtype and the final state (B,H,P,N) in f32.
//   Chunks of Q positions (the last may be shorter, L positions), with
//   cum = cumsum(dt·A) over the chunk and xd = x·dt:
//     y     = (C Bᵀ ⊙ L) @ xd + exp(cum) ⊙ (C @ S_{c−1}ᵀ),  L_ij = exp(cum_i − cum_j), i ≥ j
//     S_c   = exp(cum_L)·S_{c−1} + (xd ⊙ exp(cum_L − cum))ᵀ @ B
//
// Bound on the NVIDIA H100 80GB HBM3 at its 700.00 W limit (the published
// peaks: 3.35 TB/s, 989 TFLOP/s bf16, 67 TFLOP/s f32): at mamba2-1.3b's
// prefill shape (B=2, S=512, H=64, P=64, N=128, Q=256, bf16) the function
// moves ~22 MB (6.5 us) and its chunk products, with the scores C Bᵀ taken
// once per chunk (they do not depend on the head), are ~3.3 GFLOP (3.3 us on
// the tensor cores), so the card's bound is bytes.  In f32 the same products
// take ~49 us on the CUDA cores, and operations bound it.
//
// Design: the SSD paper's chunked decomposition (arXiv:2405.21060, section
// 6).  Every chunk runs in parallel; only the (P, N) states pass in order.
// One launch runs four kernels on the stream:
//   0. chunk_gram (one block per (64 x 64 tile j ≤ i, chunk, batch)): the
//      scores G = C Bᵀ of each chunk into the scratch gram, once for all
//      heads.
//   1. chunk_state (B·nc·H blocks): the chunk's cumsum, a block scan of dt·A
//      (kept in the scratch cum (B,H,S) for pass 3), and the chunk's own
//      state s_c = xᵀ B' with the scalar dt_j·exp(cum_L − cum_j) folded into
//      the rows of B (B'), so x enters the product as it is stored.
//   2. state_pass (one thread per 4 of (b, h, p, n)): S_c = exp(cum_L)·S_{c−1}
//      + s_c in f32, in chunk order; writes the state entering each chunk
//      c ≥ 1 (scratch: f32, or its hi and lo bf16 parts, below) and the
//      final state.
//   3. chunk_scan (one block per (64-row query tile, chunk, head, batch), a
//      chunk's heaviest query tiles first): for the key tiles j ≤ i,
//      W'_ij = G_ij·exp(cum_i − cum_j)·dt_j, then y_i = W' x +
//      exp(cum_i)·(C_i·S_{c−1}ᵀ).
// The decay is exponentiated only where i ≥ j (mask, then exponential):
// above the diagonal the exponent is positive and at Q = 256 reaches ~200,
// past f32's 88 (ROADMAP.md, fault C1).  Pass 3 takes it as exp(cum_i −
// cum_i0)·exp(cum_i0 − cum_j), i0 the query tile's first row (one
// exponential a row and a column instead of one an element), below the
// diagonal tile, where both exponents are ≤ 0, and on it where the tile's
// span keeps the second one small (split_decay).  exp(cum_L − cum_j) and
// exp(cum_i) are ≤ 1.  The accurate expf is kept.  Every output has one
// writer and every sum a fixed order: two launches agree bit for bit.  Rows past a ragged chunk or tile
// load as zeros and are never stored; P and N are padded to 16 with zeros
// in shared memory.  Results leave through shared memory in 16-byte stores.
//
// bf16: every product is mma.sync.m16n8k16 (bf16 x bf16 -> f32).  Pass 0: 4
// warps of 16 rows.  Pass 1: 8 warps, each 16 (or 32) rows of P x 64 of N,
// x by ldmatrix.trans as the A operand (rows along P), B' by
// ldmatrix.trans; KG rows of x and B are copied at once by cp.async (the
// first while the cumsum is formed).  Pass 3: 4 warps of 16 query rows;
// G_ij and x_j arrive through a two-stage cp.async ring (a third stage
// costs a block an SM); the score fragments, read from shared memory in the
// mma C layout, become W' in registers and the A operand of W' x (the C
// layout of two key tiles is the A layout of one k16 step), as
// flash_attention holds P.  Rows of x, B or C that are not 16-byte aligned
// (P or N not a multiple of 8) take an element-wise load path instead of
// cp.async, chosen by the launcher from the shapes.
//
// bf16 arithmetic: as the Pallas kernel, which computes in f32, the bf16
// instance rounds one thing, y, once as it stores it.  x, B and C are bf16
// as stored and enter their products exactly; G and every accumulator are
// f32.  The three products whose other operand is an f32 value (B' in
// xᵀB', S_{c−1} in C Sᵀ, W' in W' x) take it as two bf16 parts, hi =
// bf16(v) and lo = bf16(v − hi) (split_bf16), and run twice: a·hi + a·lo.
// v − hi is exact in f32, |v − hi| ≤ u|v| and |v − hi − lo| ≤ u²|v|, u =
// 2^-8, so each split moves its product by at most u² of its sum of
// |terms|.  The final state meets one split (B'); y's own part meets one
// (W'), its carried part two (B', then S_{c−1}): at most 2u²(1 + u²) of
// the sums of |terms| that the plain version on |x|, |B|, |C| bounds
// (ref.ssd_bf16_tolerance), beside f32 sums in another order.  Pass 2
// writes S_{c−1} as its hi and lo planes (the bytes of f32).
//
// f32: the same passes and grids on the CUDA cores, no TF32.  Each thread
// owns a 4 x 4 patch (4 x 8 where P or N is over 64) of each product and
// reads its operands from shared memory as float4 rows of transposed tiles:
// 2-4 16-byte reads for 16-64 FMAs, no scalar read per FMA.
#include <algorithm>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BT = 64;                      // positions in a tile
constexpr int KG = 128;                     // pass 1 bf16: rows copied at once
constexpr int DMAX = 128;                   // largest P and N
constexpr int THREADS = 256, WARPS = THREADS / 32;  // passes 1 (both) and 3 (f32)
constexpr int TC_THREADS = 128;             // pass 3 bf16: 4 warps x 16 rows
constexpr int LDT = BT + 4;                 // f32 row of a transposed tile
constexpr int LDG = BT + 8;                 // f32 row of a score tile (bf16 pass 3)

__host__ __device__ constexpr int up16(int n) { return (n + 15) & ~15; }

// Inclusive scan of one value per thread across a block of THREADS.
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

// Pass 1's prologue: cum[i] = Σ_{j≤i} dt_j·A over the chunk's L positions
// into shared memory and the scratch (cum_out = its (b, h) row + c0), and
// wgt[j] = dt_j·exp(cum_L − cum_j), the weight folded into row j of B.
__device__ void chunk_cumsum(const float* dtb, float a_h, int c0, int L,
                             int H, float* cum, float* wgt, float* wsum,
                             float* cum_out) {
  float carry = 0.f;
  for (int base = 0; base < L; base += THREADS) {
    const int i = base + threadIdx.x;
    const float v = i < L ? dtb[(size_t)(c0 + i) * H] * a_h : 0.f;
    const float s = block_scan(v, wsum) + carry;
    if (i < L) {
      cum[i] = s;
      cum_out[i] = s;
    }
    __syncthreads();
    carry = cum[min(base + THREADS, L) - 1];
  }
  for (int i = threadIdx.x; i < L; i += THREADS)
    wgt[i] = dtb[(size_t)(c0 + i) * H] * expf(carry - cum[i]);
  __syncthreads();
}

// Pass 3's column factors, in place over dt_j (kfac, shared memory): the
// decay exp(cum_i − cum_j) of a query row i and key j ≤ i splits as
// exp(cum_i − cum_i0)·exp(cum_i0 − cum_j), i0 the query tile's first row.
// Below the diagonal tile both exponents are ≤ 0; on it the second is ≥ 0
// and at most the tile's span cum_i0 − cum_{hi−1}, so it is split there
// only when that span is under SPLIT_SPAN (no overflow; the row factor
// then stays above e^-SPLIT_SPAN and far from underflow).  Returns whether
// the diagonal tile is split; if not, it takes exp(cum_i − cum_j) itself,
// masked first.
constexpr float SPLIT_SPAN = 64.f;
template <int NT>
__device__ bool split_decay(const float* cum, float* kfac, int i0, int hi) {
  const float cum0 = cum[i0];
  const bool split = cum0 - cum[hi - 1] < SPLIT_SPAN;
  for (int jj = threadIdx.x; jj < (split ? hi : i0); jj += NT)
    kfac[jj] *= expf(cum0 - cum[jj]);
  return split;
}

// v as hi = bf16(v) and lo = bf16(v − hi), for two values a and b packed
// as a bf16 pair each (a in the low half): hi + lo is v to u² of it.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tc::pack_bf16(a, b);
  float h[2];
  rt::Io<bf16>::unpack2(hi, h);
  lo = tc::pack_bf16(a - h[0], b - h[1]);
}

// ---- pass 2: the states, in chunk order -----------------------------------

// the state v[0..VEC) entering chunk blk = (b·nc + c)·H + h at elements
// pn..: f32 as it is; for the bf16 products, its hi and lo parts in two
// planes of PN (VEC = 4: 8-byte stores, pn and PN multiples of 4)
template <int VEC>
__device__ __forceinline__ void put_enter(float* e, size_t blk, int PN,
                                          int pn, const float* v) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) e[blk * PN + pn + i] = v[i];
}
template <int VEC>
__device__ __forceinline__ void put_enter(bf16* e, size_t blk, int PN, int pn,
                                          const float* v) {
  bf16* hi = e + blk * 2 * PN + pn;
  bf16* lo = hi + PN;
  if constexpr (VEC == 4) {
    uint32_t h[2], l[2];
    split_bf16(v[0], v[1], h[0], l[0]);
    split_bf16(v[2], v[3], h[1], l[1]);
    *reinterpret_cast<uint2*>(hi) = make_uint2(h[0], h[1]);
    *reinterpret_cast<uint2*>(lo) = make_uint2(l[0], l[1]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      hi[i] = __float2bfloat16_rn(v[i]);
      lo[i] = __float2bfloat16_rn(v[i] - __bfloat162float(hi[i]));
    }
  }
}

// VEC elements a thread (4 where P·N is a multiple of 4, in 16-byte loads)
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
state_pass(const float* __restrict__ states, const float* __restrict__ cum,
           T* __restrict__ enter, float* __restrict__ state_out, int S,
           int H, int PN, int Q, int nc) {
  const int pn = (blockIdx.x * THREADS + threadIdx.x) * VEC;
  const int h = blockIdx.y, b = blockIdx.z;
  if (pn >= PN) return;
  const float* cb = cum + ((size_t)b * H + h) * S;
  float s[VEC] = {};
  for (int c = 0; c < nc; ++c) {
    const size_t blk = ((size_t)b * nc + c) * H + h;
    float v[VEC];
    rt::lds<VEC>(states + blk * PN + pn, v);  // (a plain load of VEC floats)
    if (c > 0) put_enter<VEC>(enter, blk, PN, pn, s);
    const float d = expf(cb[min(S, (c + 1) * Q) - 1]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) s[e] = fmaf(d, s[e], v[e]);
  }
  float* so = state_out + ((size_t)b * H + h) * PN + pn;
#pragma unroll
  for (int e = 0; e < VEC; ++e) so[e] = s[e];
}

template <typename T>
cudaError_t run_state_pass(const float* states, const float* cum, void* enter,
                           void* state, int B, int S, int H, int PN, int Q,
                           int nc, cudaStream_t st) {
  if (PN % 4 == 0)
    state_pass<T, 4><<<dim3((PN / 4 + THREADS - 1) / THREADS, H, B), THREADS,
                       0, st>>>(states, cum, static_cast<T*>(enter),
                                static_cast<float*>(state), S, H, PN, Q, nc);
  else
    state_pass<T, 1><<<dim3((PN + THREADS - 1) / THREADS, H, B), THREADS, 0,
                       st>>>(states, cum, static_cast<T*>(enter),
                             static_cast<float*>(state), S, H, PN, Q, nc);
  return cudaGetLastError();
}

// ---- bf16: tensor cores ---------------------------------------------------

// rows [0, nrows) of a bf16 tile: row r of `src` (r·stride elements on) to
// dst[r·ld ..], `cols` valid of `colsp` (a multiple of 16); zeros past
// `rows` and `cols`.  vec: by cp.async (16-byte aligned rows, cols a
// multiple of 8; `base` is a valid address for the zero-filled copies),
// else element by element.
template <int NT>
__device__ void load_tile(bf16* dst, int ld, const bf16* src, size_t stride,
                          int nrows, int rows, int cols, int colsp, bool vec,
                          const bf16* base) {
  if (vec) {
    const int nch = colsp / 8;
    for (int i = threadIdx.x; i < nrows * nch; i += NT) {
      const int r = i / nch, c = (i % nch) * 8;
      const bool ok = r < rows && c < cols;
      tc::cp_async16(dst + r * ld + c, ok ? src + r * stride + c : base, ok);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * colsp; i += NT) {
      const int r = i / colsp, c = i % colsp;
      dst[r * ld + c] = r < rows && c < cols ? src[r * stride + c]
                                             : __float2bfloat16_rn(0.f);
    }
  }
}

// Pass 1, bf16: s_c = xᵀ B'_hi + xᵀ B'_lo for one (chunk, head, batch), KG
// rows of the chunk at a time (all of it for Q <= KG).  The first rows of x
// and of B are copied while the chunk's cumsum is formed; B is then
// weighted in place (hi) and its remainder written beside it (lo).  Warp w
// computes rows 16·(w % 4) (and + 64) of P against columns 64·(w / 4) of N.
__global__ void __launch_bounds__(THREADS)
chunk_state_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const bf16* __restrict__ Bm,
               float* __restrict__ states, float* __restrict__ cum_g, int S,
               int H, int P, int N, int Q, int nc, int vec) {
  extern __shared__ float4 smem4[];
  const int PP = up16(P), NP = up16(N), LDP = PP + 8, LDN = NP + 8;
  bf16* Xs = reinterpret_cast<bf16*>(smem4);  // [KG][LDP] x rows
  bf16* Bs = Xs + KG * LDP;                   // [KG][LDN] B'_hi rows
  bf16* Bl = Bs + KG * LDN;                   // [KG][LDN] B'_lo rows
  float* cum = reinterpret_cast<float*>(Bl + KG * LDN);  // [Q]
  float* wgt = cum + Q;                                   // [Q]
  float* wsum = wgt + Q;                                  // [WARPS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * Q, L = min(Q, S - c0);

  const int n0 = (warp >> 2) * 64;
  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;

  const bf16* Bb = Bm + ((size_t)b * S + c0) * N;
  for (int k0 = 0; k0 < L; k0 += KG) {
    const int rows = min(KG, L - k0);
    if (k0 > 0) __syncthreads();  // the previous rows' readers are done
    load_tile<THREADS>(Xs, LDP, x + (((size_t)b * S + c0 + k0) * H + h) * P,
                       (size_t)H * P, up16(rows), rows, P, PP, vec, x);
    if (vec)
      load_tile<THREADS>(Bs, LDN, Bb + (size_t)k0 * N, N, up16(rows), rows, N,
                         NP, true, Bm);
    tc::cp_async_commit();
    if (k0 == 0)
      chunk_cumsum(dt + (size_t)b * S * H + h, A[h], c0, L, H, cum, wgt, wsum,
                   cum_g + ((size_t)b * H + h) * S + c0);
    // B' = B · wgt in f32, as hi and lo (split_bf16); rows past `rows`
    // (zeros) stay zeros
    if (vec) {
      tc::cp_async_wait<0>();
      __syncthreads();
      const int nch = NP / 8;
      for (int i = tid; i < up16(rows) * nch; i += THREADS) {
        const int r = i / nch, o = r * LDN + (i % nch) * 8;
        uint4* p = reinterpret_cast<uint4*>(Bs + o);
        float v[8];
        rt::Io<bf16>::unpack(*p, v);
        const float w = r < rows ? wgt[k0 + r] : 0.f;
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_bf16(v[2 * e] * w, v[2 * e + 1] * w, hi[e], lo[e]);
        *p = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(Bl + o) = make_uint4(lo[0], lo[1], lo[2],
                                                       lo[3]);
      }
    } else {
      for (int i = tid; i < up16(rows) * NP; i += THREADS) {
        const int r = i / NP, cc = i % NP;
        const bool ok = r < rows && cc < N;
        const float v =
            ok ? __bfloat162float(Bb[(size_t)(k0 + r) * N + cc]) * wgt[k0 + r]
               : 0.f;
        const bf16 hi = __float2bfloat16_rn(v);
        Bs[r * LDN + cc] = hi;
        Bl[r * LDN + cc] = __float2bfloat16_rn(v - __bfloat162float(hi));
      }
      tc::cp_async_wait<0>();
    }
    __syncthreads();

    // 16 rows of the product a step: whole 64-row tiles unrolled, then the
    // ragged rest
    auto step = [&](int kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int m0 = ((warp & 3) + 4 * mi) * 16;
        if (m0 < PP)
          tc::ldsm_x4_t(af[mi], Xs + (kk * 16 + ((lane >> 4) & 1) * 8 +
                                      (lane & 7)) * LDP +
                                    m0 + ((lane >> 3) & 1) * 8);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int nb = n0 + np * 16;
        if (nb >= NP) break;
        // b0, b1 of n-tile 2np; b0, b1 of 2np + 1: of B'_hi, then B'_lo
        uint32_t bh[4], bl[4];
        const int o = (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDN +
                      nb + (lane >> 4) * 8;
        tc::ldsm_x4_t(bh, Bs + o);
        tc::ldsm_x4_t(bl, Bl + o);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if (((warp & 3) + 4 * mi) * 16 >= PP) break;
          tc::mma16816(acc[mi][2 * np], af[mi], bh[0], bh[1]);
          tc::mma16816(acc[mi][2 * np + 1], af[mi], bh[2], bh[3]);
          tc::mma16816(acc[mi][2 * np], af[mi], bl[0], bl[1]);
          tc::mma16816(acc[mi][2 * np + 1], af[mi], bl[2], bl[3]);
        }
      }
    };
    const int whole = rows / BT * (BT / 16);
    for (int kk = 0; kk < whole; kk += BT / 16) {
#pragma unroll
      for (int u = 0; u < BT / 16; ++u) step(kk + u);
    }
    for (int kk = whole; kk * 16 < rows; ++kk) step(kk);
  }

  // s_c through shared memory ([PP][NP + 8] f32 over the x and B' rows),
  // then out in 16-byte stores
  __syncthreads();
  float* Os = reinterpret_cast<float*>(smem4);
  const int LDO = NP + 8;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int m0 = ((warp & 3) + 4 * mi) * 16;
    if (m0 >= PP) break;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int n = n0 + nt * 8 + 2 * t4;
      if (n >= NP) break;
      *reinterpret_cast<float2*>(Os + (m0 + g) * LDO + n) =
          make_float2(acc[mi][nt][0], acc[mi][nt][1]);
      *reinterpret_cast<float2*>(Os + (m0 + g + 8) * LDO + n) =
          make_float2(acc[mi][nt][2], acc[mi][nt][3]);
    }
  }
  __syncthreads();
  float* so = states + (((size_t)b * nc + c) * H + h) * P * N;
  if (N % 4 == 0) {
    const int n4 = N / 4;
    for (int i = tid; i < P * n4; i += THREADS) {
      const int p = i / n4, n = (i % n4) * 4;
      *reinterpret_cast<float4*>(so + (size_t)p * N + n) =
          *reinterpret_cast<const float4*>(Os + p * LDO + n);
    }
  } else {
    for (int i = tid; i < P * N; i += THREADS)
      so[i] = Os[(i / N) * LDO + i % N];
  }
}

// (it, jt), jt ≤ it, of the lower-triangle tile with linear index t
__device__ __forceinline__ void tri_tile(int t, int& it, int& jt) {
  it = 0;
  while ((it + 1) * (it + 2) / 2 <= t) ++it;
  jt = t - it * (it + 1) / 2;
}

// Scores, bf16: G = C Bᵀ over one chunk, one 64 x 64 tile (it, jt ≤ it) a
// block, 4 warps of 16 rows; into the scratch gram (B, nc, QP, QP) f32, QP =
// nq·BT.  The scores do not depend on the head: computed once here, they
// are read by every head's pass 3.
__global__ void __launch_bounds__(TC_THREADS)
chunk_gram_tc(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
              float* __restrict__ gram, int S, int N, int Q, int nc, int nq,
              int vec) {
  extern __shared__ float4 smem4[];
  const int NP = up16(N), LDN = NP + 8;
  bf16* Cs = reinterpret_cast<bf16*>(smem4);  // [BT][LDN] C_i
  bf16* Bs = Cs + BT * LDN;                   // [BT][LDN] B_j
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  int it, jt;
  tri_tile(blockIdx.x, it, jt);
  const int c = blockIdx.y, b = blockIdx.z;
  const int c0 = c * Q, L = min(Q, S - c0), i0 = it * BT, j0 = jt * BT;
  if (i0 >= L) return;
  load_tile<TC_THREADS>(Cs, LDN, Cm + ((size_t)b * S + c0 + i0) * N, N, BT,
                        L - i0, N, NP, vec, Cm);
  load_tile<TC_THREADS>(Bs, LDN, Bm + ((size_t)b * S + c0 + j0) * N, N, BT,
                        L - j0, N, NP, vec, Bm);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  float sc[BT / 8][4];
#pragma unroll
  for (int nt = 0; nt < BT / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
  for (int kk = 0; kk * 16 < NP; ++kk) {
    uint32_t cf[4];
    tc::ldsm_x4(cf, Cs + (warp * 16 + (lane & 15)) * LDN + kk * 16 +
                        (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < BT / 16; ++np) {
      uint32_t kf[4];
      tc::ldsm_x4(kf, Bs + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LDN +
                          kk * 16 + ((lane >> 3) & 1) * 8);
      tc::mma16816(sc[2 * np], cf, kf[0], kf[1]);
      tc::mma16816(sc[2 * np + 1], cf, kf[2], kf[3]);
    }
  }
  const int QP = nq * BT;
  float* G = gram + (((size_t)b * nc + c) * QP + i0 + warp * 16 + g) * QP + j0;
#pragma unroll
  for (int nt = 0; nt < BT / 8; ++nt) {
    *reinterpret_cast<float2*>(G + nt * 8 + 2 * t4) =
        make_float2(sc[nt][0], sc[nt][1]);
    *reinterpret_cast<float2*>(G + 8 * QP + nt * 8 + 2 * t4) =
        make_float2(sc[nt][2], sc[nt][3]);
  }
}

// Pass 3, bf16: y for one 64-row query tile of one (chunk, head, batch),
// 4 warps of 16 rows.  PM: the instance's largest P (64 or 128).  Key tile
// j's x_j and score tile G_ij arrive through a two-stage cp.async ring;
// stage 1 first holds C_i and S_{c-1}'s hi and lo planes, until the
// carried state's part is taken.
template <int PM>
__global__ void __launch_bounds__(TC_THREADS)
chunk_scan_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
              const bf16* __restrict__ Cm, const bf16* __restrict__ enter,
              const float* __restrict__ gram, const float* __restrict__ cum_g,
              bf16* __restrict__ y, int S, int H, int P, int N, int Q, int nc,
              int nq, int vec) {
  extern __shared__ float4 smem4[];
  const int PP = up16(P), NP = up16(N), LDP = PP + 8, LDN = NP + 8;
  // a stage: G_ij [BT][LDG] f32, then x_j [BT][LDP] bf16
  const int stage = BT * LDG * 4 + BT * LDP * 2;  // bytes
  char* st0 = reinterpret_cast<char*>(smem4);
  char* st1 = st0 + stage;
  bf16* Cs = reinterpret_cast<bf16*>(st1);  // [BT][LDN] C_i, then stage 1
  bf16* Ss = Cs + BT * LDN;                 // [PP][LDN] S_{c-1} hi, likewise
  bf16* Sl = Ss + PP * LDN;                 // [PP][LDN] S_{c-1} lo, likewise
  float* cum = reinterpret_cast<float*>(
      st1 + max(stage, (BT + 2 * PP) * LDN * 2));  // [nq·BT]
  float* kfac = cum + nq * BT;  // [nq·BT] dt_j, then the column factors

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int qt = nq - 1 - (int)(blockIdx.x % nq), c = blockIdx.x / nq;
  const int h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * Q, L = min(Q, S - c0), i0 = qt * BT;
  if (i0 >= L) return;  // past a short last chunk
  const int hi = min(L, i0 + BT);  // positions 0..hi-1 of the chunk are read
  const int ia = i0 + warp * 16 + g, ib = ia + 8;  // this thread's rows

  const int QP = nq * BT;
  const float* Gb = gram + (((size_t)b * nc + c) * QP + i0) * QP;
  auto load_keys = [&](char* st, int j) {
    float* Gs = reinterpret_cast<float*>(st);
    for (int i = tid; i < BT * (BT / 4); i += TC_THREADS) {
      const int r = i / (BT / 4), cc = (i % (BT / 4)) * 4;
      tc::cp_async16(Gs + r * LDG + cc, Gb + (size_t)r * QP + j * BT + cc,
                     true);
    }
    load_tile<TC_THREADS>(reinterpret_cast<bf16*>(st + BT * LDG * 4), LDP,
                          x + (((size_t)b * S + c0 + j * BT) * H + h) * P,
                          (size_t)H * P, BT, L - j * BT, P, PP, vec, x);
  };
  load_keys(st0, 0);
  if (c > 0) {
    load_tile<TC_THREADS>(Cs, LDN, Cm + ((size_t)b * S + c0 + i0) * N, N, BT,
                          L - i0, N, NP, vec, Cm);
    const bf16* eb = enter + (((size_t)b * nc + c) * H + h) * 2 * P * N;
    load_tile<TC_THREADS>(Ss, LDN, eb, N, PP, P, N, NP, vec, enter);
    load_tile<TC_THREADS>(Sl, LDN, eb + P * N, N, PP, P, N, NP, vec, enter);
  }
  tc::cp_async_commit();
  const float* cb = cum_g + ((size_t)b * H + h) * S + c0;
  for (int i = tid; i < hi; i += TC_THREADS) {
    cum[i] = cb[i];
    kfac[i] = dt[((size_t)b * S + c0 + i) * H + h];
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  const bool split = split_decay<TC_THREADS>(cum, kfac, i0, hi);
  const float ra = ia < L ? expf(cum[ia] - cum[i0]) : 0.f;
  const float rb = ib < L ? expf(cum[ib] - cum[i0]) : 0.f;

  float acc[PM / 8][4];
#pragma unroll
  for (int nt = 0; nt < PM / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  if (c > 0) {  // exp(cum_i)·(C_i S_hiᵀ + C_i S_loᵀ)
    for (int kk = 0; kk * 16 < NP; ++kk) {
      uint32_t cf[4];
      tc::ldsm_x4(cf, Cs + (warp * 16 + (lane & 15)) * LDN + kk * 16 +
                          (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < PM / 16; ++np) {
        if (np * 16 >= PP) break;
        uint32_t sh[4], sl[4];
        const int o = (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LDN +
                      kk * 16 + ((lane >> 3) & 1) * 8;
        tc::ldsm_x4(sh, Ss + o);
        tc::ldsm_x4(sl, Sl + o);
        tc::mma16816(acc[2 * np], cf, sh[0], sh[1]);
        tc::mma16816(acc[2 * np + 1], cf, sh[2], sh[3]);
        tc::mma16816(acc[2 * np], cf, sl[0], sl[1]);
        tc::mma16816(acc[2 * np + 1], cf, sl[2], sl[3]);
      }
    }
    const float ea = ia < L ? expf(cum[ia]) : 0.f;
    const float eb = ib < L ? expf(cum[ib]) : 0.f;
#pragma unroll
    for (int nt = 0; nt < PM / 8; ++nt) {
      acc[nt][0] *= ea;
      acc[nt][1] *= ea;
      acc[nt][2] *= eb;
      acc[nt][3] *= eb;
    }
  }
  __syncthreads();  // C_i and S_{c-1} are read, every kfac is written

  for (int j = 0; j <= qt; ++j) {
    if (j < qt) load_keys(j & 1 ? st0 : st1, j + 1);
    tc::cp_async_commit();
    const char* st = j & 1 ? st1 : st0;
    const float* gs = reinterpret_cast<const float*>(st) + warp * 16 * LDG;
    const bf16* xs = reinterpret_cast<const bf16*>(st + BT * LDG * 4);

    // W' = scores · exp(cum_i − cum_j) · dt_j where j ≤ i < L, else 0:
    // split as row factor · column factor (split_decay), or, on a diagonal
    // tile that is not split, masked before the exponential
    const int j0 = j * BT;
    float sc[BT / 8][4];
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt) {
      const float2 u = *reinterpret_cast<const float2*>(gs + g * LDG + nt * 8 +
                                                        2 * t4);
      const float2 v = *reinterpret_cast<const float2*>(
          gs + (g + 8) * LDG + nt * 8 + 2 * t4);
      sc[nt][0] = u.x;
      sc[nt][1] = u.y;
      sc[nt][2] = v.x;
      sc[nt][3] = v.y;
    }
    if (j < qt || split) {
#pragma unroll
      for (int nt = 0; nt < BT / 8; ++nt) {
        const int jj = j0 + nt * 8 + 2 * t4;
        const float2 k = *reinterpret_cast<const float2*>(kfac + jj);
        sc[nt][0] *= ra * k.x;
        sc[nt][1] *= ra * k.y;
        sc[nt][2] *= rb * k.x;
        sc[nt][3] *= rb * k.y;
        if (j == qt) {  // the diagonal tile: j ≤ i only
          if (jj > ia) sc[nt][0] = 0.f;
          if (jj + 1 > ia) sc[nt][1] = 0.f;
          if (jj > ib) sc[nt][2] = 0.f;
          if (jj + 1 > ib) sc[nt][3] = 0.f;
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < BT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1 ? ib : ia;
          const int jj = j0 + nt * 8 + 2 * t4 + (e & 1);
          sc[nt][e] = jj <= i && i < L
                          ? sc[nt][e] * expf(cum[i] - cum[jj]) * kfac[jj]
                          : 0.f;
        }
    }
    // y += W'_hi x_j + W'_lo x_j, W' split in registers
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      const float(&p0)[4] = sc[2 * kk], (&p1)[4] = sc[2 * kk + 1];
      uint32_t ph[4], pl[4];
      split_bf16(p0[0], p0[1], ph[0], pl[0]);
      split_bf16(p0[2], p0[3], ph[1], pl[1]);
      split_bf16(p1[0], p1[1], ph[2], pl[2]);
      split_bf16(p1[2], p1[3], ph[3], pl[3]);
#pragma unroll
      for (int np = 0; np < PM / 16; ++np) {
        if (np * 16 >= PP) break;
        uint32_t vf[4];
        tc::ldsm_x4_t(vf, xs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                   LDP + np * 16 + (lane >> 4) * 8);
        tc::mma16816(acc[2 * np], ph, vf[0], vf[1]);
        tc::mma16816(acc[2 * np + 1], ph, vf[2], vf[3]);
        tc::mma16816(acc[2 * np], pl, vf[0], vf[1]);
        tc::mma16816(acc[2 * np + 1], pl, vf[2], vf[3]);
      }
    }
    tc::cp_async_wait<0>();
    __syncthreads();  // the next tile has landed; this one's readers are done
  }

  // y in bf16 through this warp's 16 rows of stage 0's x (free after the
  // last sync), then out in 16-byte stores (element by element where the
  // rows of y are not 16-byte aligned)
  bf16* ow = reinterpret_cast<bf16*>(st0 + BT * LDG * 4) + warp * 16 * LDP;
#pragma unroll
  for (int nt = 0; nt < PM / 8; ++nt) {
    if (nt * 8 >= PP) break;
    *reinterpret_cast<uint32_t*>(ow + g * LDP + nt * 8 + 2 * t4) =
        tc::pack_bf16(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<uint32_t*>(ow + (g + 8) * LDP + nt * 8 + 2 * t4) =
        tc::pack_bf16(acc[nt][2], acc[nt][3]);
  }
  __syncwarp();
  const int r0 = i0 + warp * 16;
  if (vec) {
    const int pch = P / 8;
    for (int i = lane; i < 16 * pch; i += 32) {
      const int r = i / pch, cc = (i % pch) * 8;
      if (r0 + r < L)
        *reinterpret_cast<uint4*>(y + (((size_t)b * S + c0 + r0 + r) * H + h) *
                                          P + cc) =
            *reinterpret_cast<const uint4*>(ow + r * LDP + cc);
    }
  } else {
    for (int i = lane; i < 16 * P; i += 32) {
      const int r = i / P, cc = i % P;
      if (r0 + r < L)
        y[(((size_t)b * S + c0 + r0 + r) * H + h) * P + cc] = ow[r * LDP + cc];
    }
  }
}

// ---- f32: CUDA cores --------------------------------------------------------

// acc[4·U][4·V] += a (k-major, rows rg·4 + 64u) · b (k-major, cols cg·4 + 64v)
// over k < K: per k, U + V float4 reads for 16·U·V FMAs.
template <int U, int V>
__device__ __forceinline__ void fma_patch(float (&acc)[4 * U][4 * V],
                                          const float* a, int lda,
                                          const float* b, int ldb, int K,
                                          int rg, int cg) {
  for (int k = 0; k < K; ++k) {
    float av[4 * U], bv[4 * V];
#pragma unroll
    for (int u = 0; u < U; ++u) rt::lds<4>(a + k * lda + rg * 4 + 64 * u, av + 4 * u);
#pragma unroll
    for (int v = 0; v < V; ++v) rt::lds<4>(b + k * ldb + cg * 4 + 64 * v, bv + 4 * v);
#pragma unroll
    for (int i = 0; i < 4 * U; ++i)
#pragma unroll
      for (int jv = 0; jv < 4 * V; ++jv) acc[i][jv] = fmaf(av[i], bv[jv], acc[i][jv]);
  }
}

// out[r·ld + col] = the patch of fma_patch, rows < rows, cols < cols; in
// 16-byte stores where cols and ld allow
template <int U, int V>
__device__ __forceinline__ void store_patch(const float (&acc)[4 * U][4 * V],
                                            float* out, size_t ld, int rows,
                                            int cols, int rg, int cg) {
  const bool v4 = cols % 4 == 0 && ld % 4 == 0;
#pragma unroll
  for (int i = 0; i < 4 * U; ++i) {
    const int r = rg * 4 + (i / 4) * 64 + i % 4;
    if (r >= rows) continue;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c0 = cg * 4 + 64 * v;
      float* o = out + r * ld + c0;
      if (v4 && c0 < cols) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[i][4 * v], acc[i][4 * v + 1], acc[i][4 * v + 2],
                        acc[i][4 * v + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + e < cols) o[e] = acc[i][4 * v + e];
      }
    }
  }
}

template <int U, int V>
__device__ __forceinline__ void zero(float (&acc)[U][V]) {
#pragma unroll
  for (int i = 0; i < U; ++i)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[i][j] = 0.f;
}

// Pass 1, f32: s_c = xᵀ B'; thread (rg, cg) owns rows p = rg·4 + 64u and
// columns n = cg·4 + 64v.  U, V: 64-row groups of P and of N.
template <int U, int V>
__global__ void __launch_bounds__(THREADS)
chunk_state_f32(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                float* __restrict__ states, float* __restrict__ cum_g, int S,
                int H, int P, int N, int Q, int nc) {
  extern __shared__ float4 smem4[];
  constexpr int LDX = 64 * U + 4, LDB = 64 * V + 4;
  float* Xs = reinterpret_cast<float*>(smem4);  // [BT][LDX] x rows
  float* Bs = Xs + BT * LDX;                    // [BT][LDB] B' rows
  float* cum = Bs + BT * LDB;                   // [Q]
  float* wgt = cum + Q;                         // [Q]
  float* wsum = wgt + Q;                        // [WARPS]

  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * Q, L = min(Q, S - c0);
  chunk_cumsum(dt + (size_t)b * S * H + h, A[h], c0, L, H, cum, wgt, wsum,
               cum_g + ((size_t)b * H + h) * S + c0);

  float acc[4 * U][4 * V];
  zero(acc);
  const float* Bb = Bm + ((size_t)b * S + c0) * N;
  for (int k0 = 0; k0 < L; k0 += BT) {
    const int rows = min(BT, L - k0);
    __syncthreads();
#pragma unroll 8
    for (int i = tid; i < rows * P; i += THREADS) {
      const int r = i / P, p = i % P;
      Xs[r * LDX + p] = x[(((size_t)b * S + c0 + k0 + r) * H + h) * P + p];
    }
#pragma unroll 8
    for (int i = tid; i < rows * N; i += THREADS) {
      const int r = i / N, n = i % N;
      Bs[r * LDB + n] = Bb[(size_t)(k0 + r) * N + n] * wgt[k0 + r];
    }
    __syncthreads();
    fma_patch<U, V>(acc, Xs, LDX, Bs, LDB, rows, rg, cg);
  }

  float* so = states + (((size_t)b * nc + c) * H + h) * P * N;
  store_patch<U, V>(acc, so, N, P, N, rg, cg);
}

// Scores, f32: as chunk_gram_tc on the CUDA cores; thread (rg, cg) owns
// rows rg·4.. and columns cg·4.. of the tile.
__global__ void __launch_bounds__(THREADS)
chunk_gram_f32(const float* __restrict__ Bm, const float* __restrict__ Cm,
               float* __restrict__ gram, int S, int N, int Q, int nc,
               int nq) {
  extern __shared__ float4 smem4[];
  float* CT = reinterpret_cast<float*>(smem4);  // [N][LDT] C_iᵀ
  float* BTt = CT + N * LDT;                    // [N][LDT] B_jᵀ
  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  int it, jt;
  tri_tile(blockIdx.x, it, jt);
  const int c = blockIdx.y, b = blockIdx.z;
  const int c0 = c * Q, L = min(Q, S - c0), i0 = it * BT, j0 = jt * BT;
  if (i0 >= L) return;
  const float* Cb = Cm + ((size_t)b * S + c0) * N;
  const float* Bb = Bm + ((size_t)b * S + c0) * N;
#pragma unroll 8
  for (int i = tid; i < BT * N; i += THREADS) {
    const int r = i / N, n = i % N;
    CT[n * LDT + r] = i0 + r < L ? Cb[(size_t)(i0 + r) * N + n] : 0.f;
    BTt[n * LDT + r] = j0 + r < L ? Bb[(size_t)(j0 + r) * N + n] : 0.f;
  }
  __syncthreads();
  float sc[4][4];
  zero(sc);
  fma_patch<1, 1>(sc, CT, LDT, BTt, LDT, N, rg, cg);
  const int QP = nq * BT;
  float* G = gram + (((size_t)b * nc + c) * QP + i0 + rg * 4) * QP + j0 + cg * 4;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
    *reinterpret_cast<float4*>(G + ii * QP) =
        make_float4(sc[ii][0], sc[ii][1], sc[ii][2], sc[ii][3]);
}

// Pass 3, f32: y for one 64-row query tile; thread (rg, cg) owns query rows
// rg·4.. against keys cg·4.. (scores, read from the gram scratch) and head
// dims cg·4 + 64v (y).
template <int V>
__global__ void __launch_bounds__(THREADS)
chunk_scan_f32(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ Cm, const float* __restrict__ enter,
               const float* __restrict__ gram,
               const float* __restrict__ cum_g, float* __restrict__ y, int S,
               int H, int P, int N, int Q, int nc, int nq) {
  extern __shared__ float4 smem4[];
  constexpr int LDX = 64 * V + 4;
  float* Xs = reinterpret_cast<float*>(smem4);  // [BT][LDX] x_j rows
  float* WT = Xs + BT * LDX;                    // [BT][LDT] W'ᵀ
  float* cum = WT + BT * LDT;                   // [nq·BT]
  float* kfac = cum + nq * BT;  // [nq·BT] dt_j, then the column factors
  float* CT = kfac + nq * BT;   // [N][LDT] C_iᵀ (chunks c ≥ 1)
  float* ST = CT + N * LDT;     // [N][LDX] S_{c-1}ᵀ (chunks c ≥ 1)

  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int qt = nq - 1 - (int)(blockIdx.x % nq), c = blockIdx.x / nq;
  const int h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * Q, L = min(Q, S - c0), i0 = qt * BT;
  if (i0 >= L) return;
  const int hi = min(L, i0 + BT);

  if (c > 0) {
    const float* Cb = Cm + ((size_t)b * S + c0 + i0) * N;
#pragma unroll 8
    for (int i = tid; i < BT * N; i += THREADS) {
      const int r = i / N, n = i % N;
      CT[n * LDT + r] = i0 + r < L ? Cb[(size_t)r * N + n] : 0.f;
    }
    const float* Sb = enter + (((size_t)b * nc + c) * H + h) * P * N;
#pragma unroll 8
    for (int i = tid; i < P * N; i += THREADS) {
      const int p = i / N, n = i % N;
      ST[n * LDX + p] = Sb[i];
    }
  }
  const float* cb = cum_g + ((size_t)b * H + h) * S + c0;
  for (int i = tid; i < hi; i += THREADS) {
    cum[i] = cb[i];
    kfac[i] = dt[((size_t)b * S + c0 + i) * H + h];
  }
  __syncthreads();
  const bool split = split_decay<THREADS>(cum, kfac, i0, hi);
  float rf[4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int i = i0 + rg * 4 + ii;
    rf[ii] = i < L ? expf(cum[i] - cum[i0]) : 0.f;
  }

  float acc[4][4 * V];
  zero(acc);
  if (c > 0) {  // exp(cum_i)·(C_i S_{c-1}ᵀ)
    fma_patch<1, V>(acc, CT, LDT, ST, LDX, N, rg, cg);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int i = i0 + rg * 4 + ii;
      const float e = i < L ? expf(cum[i]) : 0.f;
#pragma unroll
      for (int jv = 0; jv < 4 * V; ++jv) acc[ii][jv] *= e;
    }
  }

  const int QP = nq * BT;
  const float* G = gram + (((size_t)b * nc + c) * QP + i0 + rg * 4) * QP + cg * 4;
  for (int j = 0; j <= qt; ++j) {
    const int j0 = j * BT, rows = min(BT, L - j0);
    float sc[4][4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const float4 u = *reinterpret_cast<const float4*>(G + ii * QP + j0);
      sc[ii][0] = u.x;
      sc[ii][1] = u.y;
      sc[ii][2] = u.z;
      sc[ii][3] = u.w;
    }
    __syncthreads();  // the previous key tile's readers are done
#pragma unroll 8
    for (int i = tid; i < rows * P; i += THREADS) {
      const int r = i / P, p = i % P;
      Xs[r * LDX + p] = x[(((size_t)b * S + c0 + j0 + r) * H + h) * P + p];
    }
    // W' = scores · exp(cum_i − cum_j) · dt_j where j ≤ i < L, else 0, as
    // in the bf16 pass 3
    const bool direct = j == qt && !split;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int jp = j0 + cg * 4 + jj;
      float col[4];
      if (!direct) {
        const float k = kfac[jp];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int i = i0 + rg * 4 + ii;
          col[ii] = jp <= i && i < L ? sc[ii][jj] * rf[ii] * k : 0.f;
        }
      } else {
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int i = i0 + rg * 4 + ii;
          col[ii] = jp <= i && i < L
                        ? sc[ii][jj] * expf(cum[i] - cum[jp]) * kfac[jp]
                        : 0.f;
        }
      }
      *reinterpret_cast<float4*>(&WT[(cg * 4 + jj) * LDT + rg * 4]) =
          make_float4(col[0], col[1], col[2], col[3]);
    }
    __syncthreads();
    fma_patch<1, V>(acc, WT, LDT, Xs, LDX, rows, rg, cg);
  }

  store_patch<1, V>(acc, y + (((size_t)b * S + c0 + i0) * H + h) * P,
                    (size_t)H * P, min(BT, L - i0), P, rg, cg);
}

// ---- launch -----------------------------------------------------------------

// Lets `kern` take as much dynamic shared memory as a block may have on
// the current device, beside its static shared memory: set the first time,
// not again (a launch that asks for more still fails, at the launch).
template <auto kern>
cudaError_t allow_smem() {
  static const cudaError_t e = [] {
    int dev = 0, most = 0;
    cudaFuncAttributes fa;
    cudaError_t r = cudaGetDevice(&dev);
    if (r == cudaSuccess)
      r = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
    if (r == cudaSuccess) r = cudaFuncGetAttributes(&fa, kern);
    if (r == cudaSuccess)
      r = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          most - static_cast<int>(fa.sharedSizeBytes));
    return r;
  }();
  return e;
}

#define RT_TRY(expr)                     \
  do {                                   \
    const cudaError_t e_ = (expr);       \
    if (e_ != cudaSuccess) return e_;    \
  } while (0)

// the scratch of one launch (see ssd_launch)
struct Scratch {
  float* states;
  void* enter;
  float* cum;
  float* gram;
};

template <int PM>
cudaError_t scan_tc(dim3 grid, int smem, cudaStream_t st, const void* x,
                    const void* dt, const void* Cm, const Scratch& w, void* y,
                    int S, int H, int P, int N, int Q, int nc, int nq,
                    int vec) {
  RT_TRY(allow_smem<chunk_scan_tc<PM>>());
  chunk_scan_tc<PM><<<grid, TC_THREADS, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const bf16*>(Cm), static_cast<const bf16*>(w.enter), w.gram,
      w.cum, static_cast<bf16*>(y), S, H, P, N, Q, nc, nq, vec);
  return cudaGetLastError();
}

cudaError_t run_bf16(const void* x, const void* dt, const void* A,
                     const void* Bm, const void* Cm, void* y, void* state,
                     const Scratch& w, int B, int S, int H, int P, int N,
                     int Q, cudaStream_t st) {
  const int nc = (S + Q - 1) / Q, nq = (Q + BT - 1) / BT;
  const int PP = up16(P), NP = up16(N), LDP = PP + 8, LDN = NP + 8;
  const int vec = P % 8 == 0 && N % 8 == 0;  // 16-byte rows of x, B, C, S
  const int smem0 = 2 * BT * LDN * 2;
  rt::note_smem(smem0);
  RT_TRY(allow_smem<chunk_gram_tc>());
  chunk_gram_tc<<<dim3(nq * (nq + 1) / 2, nc, B), TC_THREADS, smem0, st>>>(
      static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm), w.gram, S,
      N, Q, nc, nq, vec);
  RT_TRY(cudaGetLastError());
  const int smem1 = KG * (LDP + 2 * LDN) * 2 + (2 * Q + WARPS) * 4;
  rt::note_smem(smem1);
  RT_TRY(allow_smem<chunk_state_tc>());
  chunk_state_tc<<<dim3(nc, H, B), THREADS, smem1, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(Bm), w.states,
      w.cum, S, H, P, N, Q, nc, vec);
  RT_TRY(cudaGetLastError());
  RT_TRY(run_state_pass<bf16>(w.states, w.cum, w.enter, state, B, S, H, P * N,
                              Q, nc, st));
  const int stage = BT * LDG * 4 + BT * LDP * 2;
  const int smem3 =
      stage + std::max(stage, (BT + 2 * PP) * LDN * 2) + 2 * nq * BT * 4;
  rt::note_smem(smem3);
  const dim3 grid(nc * nq, H, B);
  return (P <= 64 ? scan_tc<64> : scan_tc<128>)(grid, smem3, st, x, dt, Cm, w,
                                                y, S, H, P, N, Q, nc, nq,
                                                vec);
}

template <int U, int V>
cudaError_t state_f32(dim3 grid, cudaStream_t st, const void* x,
                      const void* dt, const void* A, const void* Bm,
                      const Scratch& w, int S, int H, int P, int N, int Q,
                      int nc) {
  const int smem = (BT * (64 * U + 4) + BT * (64 * V + 4) + 2 * Q + WARPS) * 4;
  rt::note_smem(smem);
  RT_TRY((allow_smem<chunk_state_f32<U, V>>()));
  chunk_state_f32<U, V><<<grid, THREADS, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm), w.states,
      w.cum, S, H, P, N, Q, nc);
  return cudaGetLastError();
}

template <int V>
cudaError_t scan_f32(dim3 grid, cudaStream_t st, const void* x,
                     const void* dt, const void* Cm, const Scratch& w,
                     void* y, int S, int H, int P, int N, int Q, int nc,
                     int nq) {
  constexpr int LDX = 64 * V + 4;
  const int smem =
      (BT * LDX + BT * LDT + 2 * nq * BT + N * LDT + N * LDX) * 4;
  rt::note_smem(smem);
  RT_TRY(allow_smem<chunk_scan_f32<V>>());
  chunk_scan_f32<V><<<grid, THREADS, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(Cm), static_cast<const float*>(w.enter),
      w.gram, w.cum, static_cast<float*>(y), S, H, P, N, Q, nc, nq);
  return cudaGetLastError();
}

cudaError_t run_f32(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, void* y, void* state,
                    const Scratch& w, int B, int S, int H, int P, int N,
                    int Q, cudaStream_t st) {
  const int nc = (S + Q - 1) / Q, nq = (Q + BT - 1) / BT;
  const int smem0 = 2 * N * LDT * 4;
  rt::note_smem(smem0);
  RT_TRY(allow_smem<chunk_gram_f32>());
  chunk_gram_f32<<<dim3(nq * (nq + 1) / 2, nc, B), THREADS, smem0, st>>>(
      static_cast<const float*>(Bm), static_cast<const float*>(Cm), w.gram, S,
      N, Q, nc, nq);
  RT_TRY(cudaGetLastError());
  auto pass1 = P <= 64 ? (N <= 64 ? state_f32<1, 1> : state_f32<1, 2>)
                       : (N <= 64 ? state_f32<2, 1> : state_f32<2, 2>);
  RT_TRY(pass1(dim3(nc, H, B), st, x, dt, A, Bm, w, S, H, P, N, Q, nc));
  RT_TRY(run_state_pass<float>(w.states, w.cum, w.enter, state, B, S, H,
                               P * N, Q, nc, st));
  return (P <= 64 ? scan_f32<1> : scan_f32<2>)(dim3(nc * nq, H, B), st, x, dt,
                                                Cm, w, y, S, H, P, N, Q, nc,
                                                nq);
}

}  // namespace

// Scratch the wrapper allocates, with nc = ceil(S / Q) and QP = 64·ceil(Q /
// 64): ws_states (B, nc, H, P, N) f32; ws_enter the same bytes: f32, or for
// bf16 (B, nc, H, 2, P, N), the hi and lo planes; ws_cum (B, H, S) f32,
// ws_gram (B, nc, QP, QP) f32.
extern "C" int ssd_launch(const void* x, const void* dt, const void* A,
                          const void* Bm, const void* Cm, void* y, void* state,
                          void* ws_states, void* ws_enter, void* ws_cum,
                          void* ws_gram, int B, int S, int H, int P, int N,
                          int Q, int dtype, void* stream) {
  rt::smem_requested() = 0;
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > DMAX || N <= 0 ||
      N > DMAX || Q <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch w{static_cast<float*>(ws_states), ws_enter,
                  static_cast<float*>(ws_cum), static_cast<float*>(ws_gram)};
  cudaError_t e;
  if (dtype == rt::kBF16)
    e = run_bf16(x, dt, A, Bm, Cm, y, state, w, B, S, H, P, N, Q, st);
  else if (dtype == rt::kF32)
    e = run_f32(x, dt, A, Bm, Cm, y, state, w, B, S, H, P, N, Q, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

RT_ERROR_STRING(ssd)
RT_REQUESTED_SMEM(ssd)
