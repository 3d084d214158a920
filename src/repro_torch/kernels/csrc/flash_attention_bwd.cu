// Backward of causal / sliding-window flash attention: dQ, dK, dV from Q, K,
// V, the forward's output O, its logsumexp and dO. The reference has no
// backward kernel: its differentiable op (src/repro/kernels/ops.py:48-79,
// _flash_diff_bwd) takes the vjp of the jnp blockwise attention, and its
// docstring names "a dedicated bwd kernel" as the next step on real
// hardware. This file is that kernel for the backward of the forward in
// flash_attention.cu (f32) and flash_attention_wgmma.cu (bf16), which
// replace src/repro/kernels/flash_attention.py::_flash_kernel.
//
// Arithmetic, held from the vjp of the reference's blockwise attention
// (scale the forward's, d^-0.5 unless a model gives its own; masked scores
// -1e30 as in the forward):
//   P  = exp(scale * Q K^T - lse)     (lse: the forward's natural-log
//                                      logsumexp of the scaled, masked row)
//   dV = P^T dO        dP = dO V^T     D = rowsum(dO o O)
//   dS = P o (dP - D)  dQ = scale * dS K    dK = scale * dS^T Q
// A key tile wholly above the causal diagonal or wholly outside the window
// is skipped for a query tile, by the forward's rule
// (kernels/flash_attention.py::flash_tiles_run).
//
// Three launches, one stream, no atomics, so two calls on the same inputs
// give the same bits:
//  1. bwd_prep: one warp per query row writes D and lse into row buffers
//     padded to a multiple of 128 queries: lse in the route's units (base
//     2 on the tensor cores) and, past seq_q, +1e30 (so P = 0 there with
//     no mask) and D = 0.
//  2. dK / dV: one CTA per (b*h, key tile), looping over the query tiles
//     that see its keys; each CTA alone writes its rows of dK and dV.
//  3. dQ: one CTA per (b*h, query tile), looping over the key tiles its
//     queries see; each CTA alone writes its rows of dQ.
// P and dP are recomputed in both 2 and 3: seven products a tile pair
// against the five the function needs, the price of having no atomics.
//
// Two routes, by dtype as the forward:
//  - f32: the CUDA cores, f32 FMAs (TF32 cannot hold the f32 tolerance),
//    64 x 64 tiles, 256 threads, every operand staged in shared memory as
//    f32 with rows padded by one float; each thread owns a 4 x 4 block of
//    a score tile and 4 rows x D/16 columns of its outputs.
//  - bf16: the tensor cores (wgmma, bf16 in, f32 accumulate) fed by TMA.
//    A CTA has two consumer warpgroups of 64 rows each and a producer
//    warpgroup whose one thread issues every load (its waits on the ring
//    trap after 10 s, hopper.cuh's hang guard). In the dK / dV kernel
//    the CTA holds 128 keys (K, V loaded once) and streams 64-query tiles
//    of Q, dO, lse and D through a two-stage ring; each warpgroup forms
//    S^T = K Q^T and dP^T = V dO^T (both operands K-major in shared
//    memory, m64n64k16), makes P^T and dS^T in registers, rounds them to
//    bf16 and feeds them as the A operand of dV += P^T dO and dK += dS^T Q
//    (dO and Q read MN-major, the transpose bit). The dQ kernel holds 128
//    queries (Q, dO, their lse and D loaded once) and streams 64-key tiles
//    of K and V: S = Q K^T, dP = dO V^T, then dQ += dS K. Tiles land
//    128-byte swizzled (64-byte at d = 32). d = 112 runs the d = 128
//    instance over TMA maps of inner extent 112 (columns 112-127 arrive as
//    zeros, which add nothing to any product) and stores 112 columns.
//
// What bounds it on an H100: operations. The function needs five products
// of 2 * s_q * s_k * d each over the visible pairs; at (8, 16, 2048, 128)
// causal that is 0.344 TFLOP, 0.347 ms at 989 TFLOP/s bf16, against 134 MB
// of inputs and outputs (0.04 ms at 3.35 TB/s). The bf16 kernels take
// about 1.31 ms there, 0.26 of that bound (chip_smoke.py phase 38 on an
// H100 80GB HBM3 at 700 W): seven products, and no overlap of the
// elementwise step with the tensor cores. The f32 route serves the f32
// wiring checks (67 TFLOP/s on the CUDA cores).
//
// Strides: q, k, v, o, dO are read as (b, h, s, d) views with d
// contiguous (on the tensor-core route q, k, v and dO through TMA: 16-byte
// bases and strides); dq, dk, dv are written through their own (b, h, s)
// strides, so the caller can hand (b, h, s, d) views of (b, s, h, d)
// memory in and out.
#include "hopper.cuh"

namespace {

constexpr float PAD_LSE = 1e30f;  // lse of a padded query row: P = 0
constexpr float LOG2E = 1.4426950408889634f;
// row buffers padded to this many queries (BWD_ROW_PAD in
// kernels/flash_attention.py, which allocates them)
constexpr int ROW_PAD = 128;

struct Strides {  // elements; d is contiguous
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os, gb, gh, gs;
  long long dqb, dqh, dqs, dkb, dkh, dks, dvb, dvh, dvs;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ bool visible(int q, int k, int causal, int window) {
  return (!causal || q >= k) && (!window || q - k < window);
}

// ---- 1. D = rowsum(dO o O) and lse, one warp per padded query row

template <typename T>
__global__ void __launch_bounds__(256)
    bwd_prep(const T* __restrict__ o, const T* __restrict__ g,
             const float* __restrict__ lse, float* __restrict__ lp,
             float* __restrict__ dp, Strides st, int n_heads, int seq_q,
             int sq_pad, int d, float lse_mul, long long rows) {
  const long long w = (blockIdx.x * 256LL + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= rows) return;
  const int bh = static_cast<int>(w / sq_pad);
  const int row = static_cast<int>(w % sq_pad);
  if (row >= seq_q) {
    if (lane == 0) {
      lp[w] = PAD_LSE;
      dp[w] = 0.f;
    }
    return;
  }
  const int bi = bh / n_heads, hi = bh % n_heads;
  const T* orow = o + bi * st.ob + hi * st.oh + row * st.os;
  const T* grow = g + bi * st.gb + hi * st.gh + row * st.gs;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc += to_f32(orow[c]) * to_f32(grow[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    lp[w] = lse[static_cast<long long>(bh) * seq_q + row] * lse_mul;
    dp[w] = acc;
  }
}

// The query tiles [begin, end) of bq rows that see a key tile [k0, k0+bk):
// the forward's skip rule read from the key side
__device__ __forceinline__ void q_tiles(int k0, int bk, int bq, int n_qt,
                                        int causal, int window, int& begin,
                                        int& end) {
  begin = 0;
  end = n_qt;
  if (causal) {
    const int lo = k0 - bq + 1;  // first q0 with q0 + bq - 1 >= k0
    if (lo > 0) begin = (lo + bq - 1) / bq;
  }
  if (window) end = min(end, (k0 + bk - 2 + window) / bq + 1);
}

// The key tiles [begin, end) of bk keys that a query tile [q0, q0+bq) sees
__device__ __forceinline__ void k_tiles(int q0, int bq, int bk, int n_kt,
                                        int causal, int window, int& begin,
                                        int& end) {
  end = n_kt;
  if (causal) end = min(end, (q0 + bq - 1) / bk + 1);
  begin = 0;
  if (window) {
    const int lo = q0 - window + 2 - bk;
    if (lo > 0) begin = (lo + bk - 1) / bk;
  }
}

// ---- 2-3, f32 on the CUDA cores

constexpr int FT = 64;    // queries and keys per tile
constexpr int FNT = 256;  // threads: 16 x 16

template <int D>
constexpr size_t f32_smem() {
  return sizeof(float) * (4 * static_cast<size_t>(FT) * (D + 1) +
                          2 * static_cast<size_t>(FT) * (FT + 1) + 2 * FT);
}

// rows [r0, r0 + FT) of a (b, h, s, d) tensor into an FT x (D + 1) tile,
// times mul, zeros past n
template <int D>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          long long rs, int r0, int n,
                                          float mul) {
  for (int idx = threadIdx.x; idx < FT * D; idx += FNT) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] = r0 + r < n ? src[(r0 + r) * rs + c] * mul : 0.f;
  }
}

// acc[i][j] = sum_d A[ty*4+i][d] * B[tx+16j][d] over FT x (D+1) tiles
template <int D>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* a,
                                         const float* b, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
  }
}

// One (query tile, key tile) pair: P and dS into Ps / dSs as [q][k].
// Qs holds scale * Q; lq, dq the tile's lse and D.
template <int D>
__device__ __forceinline__ void f32_pair(const float* Qs, const float* dOs,
                                         const float* Ks, const float* Vs,
                                         const float* lq, const float* dq,
                                         float* Ps, float* dSs, int q0,
                                         int k0, int seq_k, int causal,
                                         int window, int ty, int tx) {
  float s[4][4], dp[4][4];
  dot_tile<D>(s, Qs, Ks, ty, tx);
  dot_tile<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int kpos = k0 + c;
      float p = expf(s[i][j] - lq[r]);
      if (kpos >= seq_k || !visible(q0 + r, kpos, causal, window)) p = 0.f;
      Ps[r * (FT + 1) + c] = p;
      dSs[r * (FT + 1) + c] = p * (dp[i][j] - dq[r]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(FNT)
    bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ g,
                 const float* __restrict__ lp, const float* __restrict__ dpv,
                 float* __restrict__ dk, float* __restrict__ dv, Strides st,
                 int n_heads, int seq_q, int seq_k, int sq_pad, int causal,
                 int window, float scale) {
  constexpr int DP = D + 1, CPT = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + FT * DP;
  float* Qs = Vs + FT * DP;
  float* dOs = Qs + FT * DP;
  float* Ps = dOs + FT * DP;
  float* dSs = Ps + FT * (FT + 1);
  float* lq = dSs + FT * (FT + 1);
  float* dq = lq + FT;

  const int bh = blockIdx.x;
  const int bi = bh / n_heads, hi = bh % n_heads;
  const int k0 = blockIdx.y * FT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  stage_f32<D>(Ks, k + bi * st.kb + hi * st.kh, st.ks, k0, seq_k, 1.f);
  stage_f32<D>(Vs, v + bi * st.vb + hi * st.vh, st.vs, k0, seq_k, 1.f);

  float acc_k[4][CPT], acc_v[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  int qt_begin, qt_end;
  q_tiles(k0, FT, FT, (seq_q + FT - 1) / FT, causal, window, qt_begin,
          qt_end);
  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * FT;
    __syncthreads();  // the last tile's Qs, dOs, Ps, dSs are consumed
    stage_f32<D>(Qs, q + bi * st.qb + hi * st.qh, st.qs, q0, seq_q, scale);
    stage_f32<D>(dOs, g + bi * st.gb + hi * st.gh, st.gs, q0, seq_q, 1.f);
    if (tid < FT) {
      lq[tid] = lp[static_cast<long long>(bh) * sq_pad + q0 + tid];
      dq[tid] = dpv[static_cast<long long>(bh) * sq_pad + q0 + tid];
    }
    __syncthreads();
    f32_pair<D>(Qs, dOs, Ks, Vs, lq, dq, Ps, dSs, q0, k0, seq_k, causal,
                window, ty, tx);
    __syncthreads();
    // dV[k][c] += P[q][k] dO[q][c], dK[k][c] += dS[q][k] (scale Q)[q][c]
#pragma unroll 4
    for (int r = 0; r < FT; ++r) {
      float pv[4], sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[r * (FT + 1) + ty * 4 + i];
        sv[i] = dSs[r * (FT + 1) + ty * 4 + i];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float go = dOs[r * DP + tx + 16 * c];
        const float qq = Qs[r * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_v[i][c] += pv[i] * go;
          acc_k[i][c] += sv[i] * qq;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty * 4 + i;
    if (kpos >= seq_k) continue;
    float* krow = dk + bi * st.dkb + hi * st.dkh + kpos * st.dks;
    float* vrow = dv + bi * st.dvb + hi * st.dvh + kpos * st.dvs;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      krow[tx + 16 * c] = acc_k[i][c];
      vrow[tx + 16 * c] = acc_v[i][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(FNT)
    bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ g,
               const float* __restrict__ lp, const float* __restrict__ dpv,
               float* __restrict__ dqo, Strides st, int n_heads, int seq_q,
               int seq_k, int sq_pad, int causal, int window, float scale) {
  constexpr int DP = D + 1, CPT = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + FT * DP;
  float* Qs = Vs + FT * DP;
  float* dOs = Qs + FT * DP;
  float* Ps = dOs + FT * DP;
  float* dSs = Ps + FT * (FT + 1);
  float* lq = dSs + FT * (FT + 1);
  float* dq = lq + FT;

  const int bh = blockIdx.x;
  const int bi = bh / n_heads, hi = bh % n_heads;
  // heaviest (last) query tiles first: causal work grows with the index
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  stage_f32<D>(Qs, q + bi * st.qb + hi * st.qh, st.qs, q0, seq_q, scale);
  stage_f32<D>(dOs, g + bi * st.gb + hi * st.gh, st.gs, q0, seq_q, 1.f);
  if (tid < FT) {
    lq[tid] = lp[static_cast<long long>(bh) * sq_pad + q0 + tid];
    dq[tid] = dpv[static_cast<long long>(bh) * sq_pad + q0 + tid];
  }

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  int kt_begin, kt_end;
  k_tiles(q0, FT, FT, (seq_k + FT - 1) / FT, causal, window, kt_begin,
          kt_end);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * FT;
    __syncthreads();  // the last tile's Ks, Vs, dSs are consumed
    stage_f32<D>(Ks, k + bi * st.kb + hi * st.kh, st.ks, k0, seq_k, 1.f);
    stage_f32<D>(Vs, v + bi * st.vb + hi * st.vh, st.vs, k0, seq_k, 1.f);
    __syncthreads();
    f32_pair<D>(Qs, dOs, Ks, Vs, lq, dq, Ps, dSs, q0, k0, seq_k, causal,
                window, ty, tx);
    __syncthreads();
    // dQ[q][c] += dS[q][k] K[k][c]
#pragma unroll 4
    for (int kk = 0; kk < FT; ++kk) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(ty * 4 + i) * (FT + 1) + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float kv = Ks[kk * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += sv[i] * kv;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= seq_q) continue;
    float* row = dqo + bi * st.dqb + hi * st.dqh + qpos * st.dqs;
#pragma unroll
    for (int c = 0; c < CPT; ++c) row[tx + 16 * c] = acc[i][c] * scale;
  }
}

// ---- 2-3, bf16 on the tensor cores

constexpr int N_CONSUMERS = 256;  // two warpgroups of 64 rows
constexpr int N_THREADS = N_CONSUMERS + 128;  // + the producer warpgroup
constexpr int BIG = 128;  // rows a CTA owns: keys (dK / dV) or queries (dQ)
constexpr int SMALL = 64;  // rows of a streamed tile
constexpr int STAGES = 2;

// A tile of R rows x D columns is stored as D / CHUNK column chunks, each
// R rows of CHUNK bf16 (ROWB bytes), swizzled by TMA in atoms of 8 rows.
template <int D>
struct Geo {
  static constexpr int CHUNK = D == 32 ? 32 : 64;
  static constexpr int ROWB = CHUNK * 2;
  static constexpr int NCH = D / CHUNK;
  static constexpr uint64_t LAYOUT = D == 32 ? 2 : 1;  // 64B / 128B swizzle
  static constexpr int ATOM = 8 * ROWB;
  static constexpr int BIG_BYTES = BIG * D * 2;
  static constexpr int SMALL_BYTES = SMALL * D * 2;
  // two BIG tiles, then per stage two SMALL tiles and 2 x 64 floats
  static constexpr int RING_OFF = 2 * BIG_BYTES;
  static constexpr int VEC_OFF = RING_OFF + STAGES * 2 * SMALL_BYTES;
  static constexpr int BAR_OFF = VEC_OFF + STAGES * 2 * SMALL * 4;
  static constexpr int ALLOC = BAR_OFF + 128 + 1024;
};

// K-major descriptor (the contraction runs along d) of k-step kk for rows
// row0.. of an R-row tile
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int row0,
                                           int kk) {
  using G = Geo<D>;
  const int col = kk * 16;
  return make_desc(tile + (col / G::CHUNK) * rows * G::ROWB + row0 * G::ROWB +
                       (col % G::CHUNK) * 2,
                   16, G::ATOM, G::LAYOUT);
}

// MN-major descriptor (the contraction runs along the rows) of k-step kk
// of an R-row tile used as B (rows x D)
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int kk) {
  using G = Geo<D>;
  return make_desc(tile + kk * 16 * G::ROWB, rows * G::ROWB, G::ATOM,
                   G::LAYOUT);
}

// 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) into shared memory, completing on an mbarrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// S (64 x 64, f32) = A rows row0.. of a BIG tile times B^T, B a SMALL tile,
// both K-major: the contraction over d
template <int D>
__device__ __forceinline__ void issue_big_small(float (&s)[32], uint32_t big,
                                                int row0, uint32_t small) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64<0>(s, desc_k<D>(big, BIG, row0, kk),
                    desc_k<D>(small, SMALL, 0, kk), kk > 0);
}

// accumulator element j of a thread: row r0 + 8*((j>>1)&1), column
// 8*(j/4) + cq + (j&1) of its warpgroup's 64-row tile; the layout of
// columns 16kk..16kk+15 is the A-operand layout of k-step kk
__device__ __forceinline__ void to_frags(const float (&x)[32],
                                         uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// rows of a warpgroup's (64 x D) f32 accumulator times mul, as bf16 pairs,
// for rows below n and columns below head_dim
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           __nv_bfloat16* base, long long rs,
                                           int row0, int n, int head_dim,
                                           float mul, int r0, int cq) {
#pragma unroll
  for (int j = 0; j < D / 2; j += 2) {
    const int row = row0 + r0 + 8 * ((j >> 1) & 1);
    const int col = 8 * (j / 4) + cq;
    if (row < n && col < head_dim)
      *reinterpret_cast<uint32_t*>(base + row * rs + col) =
          pack_bf16(acc[j] * mul, acc[j + 1] * mul);
  }
}

struct OutPtr {
  __nv_bfloat16* p;
  long long b, h, s;
};

template <int D>
__global__ void __launch_bounds__(N_THREADS, 1)
    bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_g,
                   const float* __restrict__ lp, const float* __restrict__ dpv,
                   OutPtr dk, OutPtr dv, int n_heads, int seq_q, int seq_k,
                   int sq_pad, int head_dim, int causal, int window,
                   float scale, float scale_log2) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t s_k = smem_addr(smem);
  const uint32_t s_v = s_k + G::BIG_BYTES;
  auto s_q = [&](int st) { return s_k + G::RING_OFF + st * 2 * G::SMALL_BYTES; };
  auto s_g = [&](int st) { return s_q(st) + G::SMALL_BYTES; };
  const float* vecs = reinterpret_cast<const float*>(smem + G::VEC_OFF);
  const uint32_t bar = s_k + G::BAR_OFF;
  // barriers: K and V, then per stage full and empty
  const uint32_t kv_full = bar;
  auto full = [&](int st) { return bar + 8 * (1 + 2 * st); };
  auto empty = [&](int st) { return bar + 8 * (2 + 2 * st); };

  const int bh = blockIdx.x;
  const int bi = bh / n_heads, hi = bh % n_heads;
  const int k0 = blockIdx.y * BIG;  // causal: the first key tiles are heaviest
  int qt_begin, qt_end;
  q_tiles(k0, BIG, SMALL, (seq_q + SMALL - 1) / SMALL, causal, window,
          qt_begin, qt_end);
  const int n_run = max(qt_end - qt_begin, 0);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), N_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= N_CONSUMERS) {
    // ---- producer: one lane issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == N_CONSUMERS && n_run > 0) {
      mbar_expect_tx(kv_full, 2 * G::BIG_BYTES);
      for (int c = 0; c < G::NCH; ++c) {
        tma_load_4d(s_k + c * BIG * G::ROWB, &tm_k, kv_full, c * G::CHUNK, k0,
                    hi, bi);
        tma_load_4d(s_v + c * BIG * G::ROWB, &tm_v, kv_full, c * G::CHUNK, k0,
                    hi, bi);
      }
      const long long row_base = static_cast<long long>(bh) * sq_pad;
      for (int i = 0; i < n_run; ++i) {
        const int st = i % STAGES, q0 = (qt_begin + i) * SMALL;
        mbar_wait_or_trap(empty(st), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(st), 2 * G::SMALL_BYTES + 2 * SMALL * 4);
        for (int c = 0; c < G::NCH; ++c) {
          tma_load_4d(s_q(st) + c * SMALL * G::ROWB, &tm_q, full(st),
                      c * G::CHUNK, q0, hi, bi);
          tma_load_4d(s_g(st) + c * SMALL * G::ROWB, &tm_g, full(st),
                      c * G::CHUNK, q0, hi, bi);
        }
        const uint32_t vec = s_k + G::VEC_OFF + st * 2 * SMALL * 4;
        bulk_load(vec, lp + row_base + q0, SMALL * 4, full(st));
        bulk_load(vec + SMALL * 4, dpv + row_base + q0, SMALL * 4, full(st));
      }
      for (int i = max(n_run - STAGES, 0); i < n_run; ++i)
        mbar_wait_or_trap(empty(i % STAGES), (i / STAGES) & 1);
    }
    return;
  }

  // ---- consumers: warpgroup wg owns keys k0 + 64 wg ..
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int kw = k0 + wg * 64;
  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc_k[j] = acc_v[j] = 0.f;

  if (n_run > 0) mbar_wait(kv_full, 0);
  for (int i = 0; i < n_run; ++i) {
    const int st = i % STAGES, q0 = (qt_begin + i) * SMALL;
    mbar_wait(full(st), (i / STAGES) & 1);
    float s[32], dp[32];
    wgmma_fence();
    issue_big_small<D>(s, s_k, wg * 64, s_q(st));   // S^T = K Q^T
    issue_big_small<D>(dp, s_v, wg * 64, s_g(st));  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    const float* lq = vecs + st * 2 * SMALL;
    const float* dq = lq + SMALL;
    // uniform over the warpgroup: some (query, key) pair of the tile is
    // masked by the diagonal or the window
    const bool mask = (causal && q0 < kw + 63) ||
                      (window && q0 + 63 - kw >= window);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 8 * (j / 4) + cq + (j & 1);  // query column
      float p = exp2f(s[j] * scale_log2 - lq[c]);
      if (mask && !visible(q0 + c, kw + r0 + 8 * ((j >> 1) & 1), causal,
                           window))
        p = 0.f;
      s[j] = p;
      dp[j] = p * (dp[j] - dq[c]);
    }
    uint32_t pf[4][4], df[4][4];
    to_frags(s, pf);
    to_frags(dp, df);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(acc_v, pf[kk], desc_mn<D>(s_g(st), SMALL, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(acc_k, df[kk], desc_mn<D>(s_q(st), SMALL, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_v);
    fence_regs(acc_k);
    mbar_arrive(empty(st));
  }
  store_rows<D>(acc_k, dk.p + bi * dk.b + hi * dk.h, dk.s, kw, seq_k,
                head_dim, scale, r0, cq);
  store_rows<D>(acc_v, dv.p + bi * dv.b + hi * dv.h, dv.s, kw, seq_k,
                head_dim, 1.f, r0, cq);
}

template <int D>
__global__ void __launch_bounds__(N_THREADS, 1)
    bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_g,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const float* __restrict__ lp, const float* __restrict__ dpv,
                 OutPtr dq, int n_heads, int seq_q, int seq_k, int sq_pad,
                 int head_dim, int causal, int window, float scale,
                 float scale_log2) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t s_q = smem_addr(smem);
  const uint32_t s_g = s_q + G::BIG_BYTES;
  auto s_k = [&](int st) { return s_q + G::RING_OFF + st * 2 * G::SMALL_BYTES; };
  auto s_v = [&](int st) { return s_k(st) + G::SMALL_BYTES; };
  const uint32_t bar = s_q + G::BAR_OFF;
  const uint32_t qg_full = bar;
  auto full = [&](int st) { return bar + 8 * (1 + 2 * st); };
  auto empty = [&](int st) { return bar + 8 * (2 + 2 * st); };

  const int bh = blockIdx.x;
  const int bi = bh / n_heads, hi = bh % n_heads;
  // heaviest (last) query tiles first: causal work grows with the index
  const int q_start = (gridDim.y - 1 - blockIdx.y) * BIG;
  int kt_begin, kt_end;
  k_tiles(q_start, BIG, SMALL, (seq_k + SMALL - 1) / SMALL, causal, window,
          kt_begin, kt_end);
  const int n_run = max(kt_end - kt_begin, 0);

  if (threadIdx.x == 0) {
    mbar_init(qg_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), N_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= N_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == N_CONSUMERS && n_run > 0) {
      mbar_expect_tx(qg_full, 2 * G::BIG_BYTES);
      for (int c = 0; c < G::NCH; ++c) {
        tma_load_4d(s_q + c * BIG * G::ROWB, &tm_q, qg_full, c * G::CHUNK,
                    q_start, hi, bi);
        tma_load_4d(s_g + c * BIG * G::ROWB, &tm_g, qg_full, c * G::CHUNK,
                    q_start, hi, bi);
      }
      for (int i = 0; i < n_run; ++i) {
        const int st = i % STAGES, kpos = (kt_begin + i) * SMALL;
        mbar_wait_or_trap(empty(st), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(st), 2 * G::SMALL_BYTES);
        for (int c = 0; c < G::NCH; ++c) {
          tma_load_4d(s_k(st) + c * SMALL * G::ROWB, &tm_k, full(st),
                      c * G::CHUNK, kpos, hi, bi);
          tma_load_4d(s_v(st) + c * SMALL * G::ROWB, &tm_v, full(st),
                      c * G::CHUNK, kpos, hi, bi);
        }
      }
      for (int i = max(n_run - STAGES, 0); i < n_run; ++i)
        mbar_wait_or_trap(empty(i % STAGES), (i / STAGES) & 1);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int qw = q_start + wg * 64;  // this warpgroup's rows
  float lrow[2], drow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long idx = static_cast<long long>(bh) * sq_pad + qw + r0 + 8 * r;
    lrow[r] = lp[idx];
    drow[r] = dpv[idx];
  }
  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;

  if (n_run > 0) mbar_wait(qg_full, 0);
  for (int i = 0; i < n_run; ++i) {
    const int st = i % STAGES, kpos0 = (kt_begin + i) * SMALL;
    mbar_wait(full(st), (i / STAGES) & 1);
    float s[32], dp[32];
    wgmma_fence();
    issue_big_small<D>(s, s_q, wg * 64, s_k(st));   // S = Q K^T
    issue_big_small<D>(dp, s_g, wg * 64, s_v(st));  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    const bool mask = kpos0 + 64 > seq_k || (causal && kpos0 + 63 > qw) ||
                      (window && qw + 63 - kpos0 >= window);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int r = (j >> 1) & 1;
      const int kpos = kpos0 + 8 * (j / 4) + cq + (j & 1);
      float p = exp2f(s[j] * scale_log2 - lrow[r]);
      if (mask && (kpos >= seq_k ||
                   !visible(qw + r0 + 8 * r, kpos, causal, window)))
        p = 0.f;
      dp[j] = p * (dp[j] - drow[r]);
    }
    uint32_t df[4][4];
    to_frags(dp, df);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(acc, df[kk], desc_mn<D>(s_k(st), SMALL, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty(st));
  }
  store_rows<D>(acc, dq.p + bi * dq.b + hi * dq.h, dq.s, qw, seq_q, head_dim,
                scale, r0, cq);
}

// ---- host side

int prep_launch(bool bf16, const void* o, const void* g, const float* lse,
                float* lp, float* dp, const Strides& st, int b, int h,
                int seq_q, int d, float lse_mul, cudaStream_t stream) {
  const int sq_pad = (seq_q + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
  const long long rows = static_cast<long long>(b) * h * sq_pad;
  const unsigned blocks = static_cast<unsigned>((rows + 7) / 8);
  if (bf16)
    bwd_prep<__nv_bfloat16><<<blocks, 256, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(g), lse, lp, dp, st, h, seq_q,
        sq_pad, d, lse_mul, rows);
  else
    bwd_prep<float><<<blocks, 256, 0, stream>>>(
        static_cast<const float*>(o), static_cast<const float*>(g), lse, lp,
        dp, st, h, seq_q, sq_pad, d, lse_mul, rows);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* g,
               void* dq, void* dk, void* dv, const float* lp, const float* dp,
               int b, int h, int seq_q, int seq_k, int causal, int window,
               float scale, const Strides& st, cudaStream_t stream) {
  constexpr size_t smem = f32_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      bwd_dkdv_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(bwd_dq_f32<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int sq_pad = (seq_q + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* gf = static_cast<const float*>(g);
  bwd_dkdv_f32<D><<<dim3(b * h, (seq_k + FT - 1) / FT), FNT, smem, stream>>>(
      qf, kf, vf, gf, lp, dp, static_cast<float*>(dk), static_cast<float*>(dv),
      st, h, seq_q, seq_k, sq_pad, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_dq_f32<D><<<dim3(b * h, (seq_q + FT - 1) / FT), FNT, smem, stream>>>(
      qf, kf, vf, gf, lp, dp, static_cast<float*>(dq), st, h, seq_q, seq_k,
      sq_pad, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// A (b, h, s, d) bf16 tensor as a 4-D TMA map, innermost first, with boxes
// of (CHUNK columns, rows) swizzled for wgmma; columns d..D-1 and rows past
// s are out of bounds (zero-filled)
template <int D>
int make_map(CUtensorMap* map, const void* base, int b, int h, int s, int d,
             long long sb, long long sh, long long ss, int rows) {
  using G = Geo<D>;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t gstrides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                  static_cast<cuuint64_t>(sh) * 2,
                                  static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(G::CHUNK),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      gstrides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + static_cast<int>(r);
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* g,
                 void* dq, void* dk, void* dv, const float* lp,
                 const float* dp, int b, int h, int seq_q, int seq_k, int d,
                 int causal, int window, float scale, const Strides& st,
                 cudaStream_t stream) {
  using G = Geo<D>;
  CUtensorMap k_big, v_big, q_small, g_small, q_big, g_big, k_small, v_small;
  int err = make_map<D>(&k_big, k, b, h, seq_k, d, st.kb, st.kh, st.ks, BIG);
  if (!err) err = make_map<D>(&v_big, v, b, h, seq_k, d, st.vb, st.vh, st.vs, BIG);
  if (!err)
    err = make_map<D>(&q_small, q, b, h, seq_q, d, st.qb, st.qh, st.qs, SMALL);
  if (!err)
    err = make_map<D>(&g_small, g, b, h, seq_q, d, st.gb, st.gh, st.gs, SMALL);
  if (!err) err = make_map<D>(&q_big, q, b, h, seq_q, d, st.qb, st.qh, st.qs, BIG);
  if (!err) err = make_map<D>(&g_big, g, b, h, seq_q, d, st.gb, st.gh, st.gs, BIG);
  if (!err)
    err = make_map<D>(&k_small, k, b, h, seq_k, d, st.kb, st.kh, st.ks, SMALL);
  if (!err)
    err = make_map<D>(&v_small, v, b, h, seq_k, d, st.vb, st.vh, st.vs, SMALL);
  if (err) return err;
  // the attribute holds per device: set it once on each
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !attr_set[dev]) {
    e = cudaFuncSetAttribute(bwd_dkdv_wgmma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G::ALLOC);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(bwd_dq_wgmma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               G::ALLOC);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) attr_set[dev] = true;
  }
  const int sq_pad = (seq_q + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
  const OutPtr odk{static_cast<__nv_bfloat16*>(dk), st.dkb, st.dkh, st.dks};
  const OutPtr odv{static_cast<__nv_bfloat16*>(dv), st.dvb, st.dvh, st.dvs};
  const OutPtr odq{static_cast<__nv_bfloat16*>(dq), st.dqb, st.dqh, st.dqs};
  bwd_dkdv_wgmma<D><<<dim3(b * h, (seq_k + BIG - 1) / BIG), N_THREADS,
                      G::ALLOC, stream>>>(
      k_big, v_big, q_small, g_small, lp, dp, odk, odv, h, seq_q, seq_k,
      sq_pad, d, causal, window, scale, scale * LOG2E);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_dq_wgmma<D><<<dim3(b * h, (seq_q + BIG - 1) / BIG), N_THREADS,
                    G::ALLOC, stream>>>(
      q_big, g_big, k_small, v_small, lp, dp, odq, h, seq_q, seq_k, sq_pad, d,
      causal, window, scale, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

Strides read_strides(const long long* x) {
  return Strides{x[0],  x[1],  x[2],  x[3],  x[4],  x[5],  x[6],  x[7],
                 x[8],  x[9],  x[10], x[11], x[12], x[13], x[14], x[15],
                 x[16], x[17], x[18], x[19], x[20], x[21], x[22], x[23]};
}

}  // namespace

// q, o, g (dO), dq: (b, h, seq_q, d); k, v, dk, dv: (b, h, seq_k, d); all
// float32 with d contiguous, d in {32, 64, 112, 128}; lse: (b, h, seq_q)
// f32 contiguous, the forward's natural-log logsumexp; lp, dp: scratch of
// b * h * round_up(seq_q, 128) floats each. strides: 24 element strides
// (b, h, s) of q, k, v, o, g, dq, dk, dv, in that order. Three launches on
// `stream`; returns 0 or the first cudaError_t.
extern "C" int smlt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* g,
    const float* lse, void* dq, void* dk, void* dv, float* lp, float* dp,
    int b, int h, int seq_q, int seq_k, int d, int causal, int window,
    float scale, const long long* strides, void* stream) {
  if (b < 1 || h < 1 || seq_q < 1 || seq_k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st = read_strides(strides);
  int err = prep_launch(false, o, g, lse, lp, dp, st, b, h, seq_q, d, 1.f, s);
  if (err) return err;
  switch (d) {
    case 32:
      return launch_f32<32>(q, k, v, g, dq, dk, dv, lp, dp, b, h, seq_q, seq_k,
                            causal, window, scale, st, s);
    case 64:
      return launch_f32<64>(q, k, v, g, dq, dk, dv, lp, dp, b, h, seq_q, seq_k,
                            causal, window, scale, st, s);
    case 112:
      return launch_f32<112>(q, k, v, g, dq, dk, dv, lp, dp, b, h, seq_q,
                             seq_k, causal, window, scale, st, s);
    case 128:
      return launch_f32<128>(q, k, v, g, dq, dk, dv, lp, dp, b, h, seq_q,
                             seq_k, causal, window, scale, st, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same for bf16 q, k, v, o, g, dq, dk, dv (lse, lp, dp f32); q, k, v
// and g are read through TMA: 16-byte aligned bases, strides multiples of
// 8 elements. Returns 0, a cudaError_t, or 9001 / 9100 + CUresult when the
// TMA descriptors cannot be made.
extern "C" int smlt_flash_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* o, const void* g,
    const float* lse, void* dq, void* dk, void* dv, float* lp, float* dp,
    int b, int h, int seq_q, int seq_k, int d, int causal, int window,
    float scale, const long long* strides, void* stream) {
  if (b < 1 || h < 1 || seq_q < 1 || seq_k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st = read_strides(strides);
  if (d != 32 && d != 64 && d != 112 && d != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = prep_launch(true, o, g, lse, lp, dp, st, b, h, seq_q, d, LOG2E, s);
  if (err) return err;
  switch (d) {
    case 32:
      return launch_wgmma<32>(q, k, v, g, dq, dk, dv, lp, dp, b, h, seq_q,
                              seq_k, d, causal, window, scale, st, s);
    case 64:
      return launch_wgmma<64>(q, k, v, g, dq, dk, dv, lp, dp, b, h, seq_q,
                              seq_k, d, causal, window, scale, st, s);
    default:  // 112 runs the 128 instance, columns 112-127 zero-filled
      return launch_wgmma<128>(q, k, v, g, dq, dk, dv, lp, dp, b, h, seq_q,
                               seq_k, d, causal, window, scale, st, s);
  }
}
