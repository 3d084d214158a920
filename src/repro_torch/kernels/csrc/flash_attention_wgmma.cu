// Causal / sliding-window attention forward for bf16 on Hopper's tensor
// cores (wgmma), with K and V tiles fed by TMA through a two-stage ring.
// Replaces the Pallas kernel
// src/repro/kernels/flash_attention.py::_flash_kernel for bf16 inputs; f32
// stays on the CUDA-core kernel in flash_attention.cu, since on the tensor
// cores f32 would run as TF32 and could not hold the f32 tolerance.
//
// Semantics held from the reference: scores and the running (m, l, acc)
// are f32; q is scaled by `scale` (the caller's; d^-0.5 unless a model
// gives its own), applied here to the f32 scores after
// Q K^T (the same as (q * scale) . k up to f32 rounding); masked scores
// are -1e30 (not -inf); a K tile wholly above the causal diagonal or wholly
// outside the window is skipped; keys at or past seq_k are masked; queries
// past seq_q are not stored; the output is acc / max(l, 1e-30), rounded
// once to bf16. Given an lse buffer it also stores each query's
// natural-log logsumexp, (m + log2(max(l, 1e-30))) ln 2 from the base-2 m
// and l, for the backward in flash_attention_bwd.cu. The softmax runs in
// base 2: log2(e) is folded into the
// score scale and exp2f replaces expf (exp(x) = 2^(x log2 e)); masked
// scores stay -1e30, so a row with nothing visible yet still weighs its
// masked keys uniformly, as the reference does. P is rounded to bf16 for
// the P V product; l sums the f32 P. Built without fast math.
//
// What bounds it on an H100: operations. At the training shape
// (b*h = 32, s = 2048, d = 128) a call does 4*b*h*d*s^2/2 causal FLOPs on
// 67 MB of q, k, v and out, so the least time is set by the 989 TFLOP/s
// bf16 tensor-core rate: 0.035 ms. This kernel takes about 0.09 ms there,
// some 380 TFLOP/s (chip_smoke.py phase 6 on an H100 80GB HBM3 at 700 W).
//
// Design: one CTA per (b*h, 128-query tile), heaviest causal tiles first,
// with 384 threads: two consumer warpgroups of 64 query rows each and a
// producer warpgroup, which hands its registers to them (setmaxnreg) and
// of which one thread issues every load. The producer loads the Q tile
// once, then keeps a 2-stage ring of 128-key K and V tiles in flight with
// TMA; each slot has a full barrier (TMA bytes landed) and an empty one
// (all 256 consumers done), for K and for V apart, so the next K can land
// while P V still reads the last V. Tiles land 128-byte swizzled (64-byte
// at d = 32) in dynamic shared memory: Q 32 KB + 2 x (K 32 KB + V 32 KB) =
// 160 KB at d = 128. Each consumer warpgroup computes S = Q K^T with wgmma
// from shared memory (both operands K-major) into registers (each row
// spans a quad of 4 threads, so the row max is two shuffles), masks
// element by element only on tiles that cross the diagonal, the window
// edge or seq_k, converts P to bf16 in registers and feeds it to wgmma as
// the A operand; V is the B operand from shared memory, stored keys x d,
// so it is MN-major (the transpose bit). Within a warpgroup the loop is
// software-pipelined: tile i's S product is issued ahead of tile i-1's
// P V, and tile i's softmax runs while the tensor cores finish that P V.
// The epilogue divides, rounds to bf16, stages the tile in its own Q rows
// and stores 16-byte vectors, coalesced. The producer's barrier waits time
// out after 10 s and trap, so a lost barrier ends the launch with an error.
//
// Strides: q, k and v are read as (b, h, s, d) views with d contiguous and
// any other strides that are multiples of 16 bytes (the TMA descriptors
// carry them), so the model's transposed (b, s, h, d) tensors need no copy;
// the output is written through its own strides.
//
// Head dims: 32, 64 and 128 each have their own instance; 112 (zamba2's
// 3584 / 32) runs the 128 instance over TMA maps whose inner extent is the
// true 112. The boxes stay two chunks of 64 columns, so columns 112-127
// arrive as zeros (out-of-bounds fill) and still count in the barrier's
// transaction bytes, as rows past seq do: zero K columns leave S = Q K^T
// unchanged, zero V columns give output columns 112-127 that the store,
// masked to d, never writes.
#include "hopper.cuh"

namespace {

constexpr int BQ = 128;            // queries per CTA (two warpgroups of 64)
constexpr int BK = 128;            // keys per tile (S is m64n128k16)
constexpr int STAGES = 2;          // K/V ring depth
constexpr int N_CONSUMERS = 256;   // two warpgroups
// and a producer warpgroup: one of its lanes issues the loads, and all its
// 128 threads drop to 24 registers so that the consumers can rise to 240
// (setmaxnreg draws on what the CTA gives back: 128 x (168 - 24) =
// 256 x (240 - 168))
constexpr int N_THREADS = N_CONSUMERS + 128;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared-memory geometry for head dim D. A tile of R rows is stored as D /
// CHUNK column chunks, each R rows of CHUNK bf16 (ROWB bytes), swizzled by
// TMA in atoms of 8 rows.
template <int D>
struct Geo {
  static constexpr int CHUNK = D == 32 ? 32 : 64;
  static constexpr int ROWB = CHUNK * 2;        // 64 or 128 bytes
  static constexpr int NCH = D / CHUNK;
  static constexpr uint64_t LAYOUT = D == 32 ? 2 : 1;  // wgmma: 64B / 128B swizzle
  static constexpr int ATOM = 8 * ROWB;         // bytes of 8 swizzled rows
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int ALLOC = BAR_OFF + 128 + 1024;  // + barriers, + alignment
};

// K-major descriptor of k-step kk (16 columns) for rows row0.. of an R-row
// tile: the chunk holding the step, then 32 bytes a step inside its rows
template <int D>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int rows,
                                                int row0, int kk) {
  using G = Geo<D>;
  const int col = kk * 16;
  const uint32_t addr = tile + (col / G::CHUNK) * rows * G::ROWB +
                        row0 * G::ROWB + (col % G::CHUNK) * 2;
  return make_desc(addr, 16, G::ATOM, G::LAYOUT);
}

// MN-major descriptor of k-step kk (16 keys) of a V tile (keys x D): the
// step moves 16 rows; LBO steps between column chunks, SBO between 8-row
// groups
template <int D>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  using G = Geo<D>;
  return make_desc(tile + kk * 16 * G::ROWB, BK * G::ROWB, G::ATOM, G::LAYOUT);
}


struct OutStrides {
  long long b, h, s;  // elements; d is contiguous
};

// One tile's online-softmax step on the two rows this thread holds (base
// 2): scale, mask where the tile needs it, update (m, l) and return the
// factor alpha that rescales the accumulator; s becomes f32 P.
__device__ __forceinline__ void softmax_step(float (&s)[BK / 2],
                                             float (&m_i)[2], float (&l_i)[2],
                                             float (&alpha)[2], bool mask,
                                             int qpos0, int kpos0, int seq_k,
                                             int causal, int window,
                                             float scale_log2) {
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) s[j] *= scale_log2;
  if (mask) {
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int qpos = qpos0 + 8 * ((j >> 1) & 1);
      const int kpos = kpos0 + 8 * (j / 4) + (j & 1);
      bool keep = kpos < seq_k;
      if (causal) keep = keep && qpos >= kpos;
      if (window) keep = keep && qpos - kpos < window;
      s[j] = keep ? s[j] : NEG_INF;
    }
  }
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < BK / 2; ++j)
    mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
  float m_new[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    m_new[r] = fmaxf(m_i[r], mx[r]);
    alpha[r] = exp2f(m_i[r] - m_new[r]);
    m_i[r] = m_new[r];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) {
    s[j] = exp2f(s[j] - m_new[(j >> 1) & 1]);
    rs[(j >> 1) & 1] += s[j];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_i[r] = alpha[r] * l_i[r] + rs[r];
}

// P to bf16 A fragments: the accumulator layout of S columns 16kk..16kk+15
// is the A-operand layout of k-step kk
__device__ __forceinline__ void to_fragments(const float (&s)[BK / 2],
                                             uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      p[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
}

template <int D>
__global__ void __launch_bounds__(N_THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           __nv_bfloat16* __restrict__ o, OutStrides os,
                           float* __restrict__ lse, int n_heads, int seq_q, int seq_k, int head_dim,
                           int causal, int window, float scale_log2) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t s_q = smem_addr(smem);
  const uint32_t s_k = s_q + G::K_OFF;
  const uint32_t s_v = s_q + G::V_OFF;
  const uint32_t bar = s_q + G::BAR_OFF;
  // barriers: q_full, then for each stage k_full, v_full, k_empty, v_empty
  const uint32_t q_full = bar;
  auto k_full = [&](int s) { return bar + 8 * (1 + 4 * s); };
  auto v_full = [&](int s) { return bar + 8 * (2 + 4 * s); };
  auto k_empty = [&](int s) { return bar + 8 * (3 + 4 * s); };
  auto v_empty = [&](int s) { return bar + 8 * (4 + 4 * s); };

  const int bh = blockIdx.x;
  const int bi = bh / n_heads, hi = bh % n_heads;
  // heaviest (last) query tiles first: causal work grows with the tile index
  const int q_start = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int n_tiles = (seq_k + BK - 1) / BK;
  // the reference's skip rule: tiles [kt_begin, kt_end) hold a visible key
  int kt_end = n_tiles;
  if (causal) kt_end = min(kt_end, (q_start + BQ - 1) / BK + 1);
  int kt_begin = 0;
  if (window) {
    const int lo = q_start - window + 2 - BK;  // first k_start that runs
    if (lo > 0) kt_begin = (lo + BK - 1) / BK;
  }
  const int n_run = max(kt_end - kt_begin, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), N_CONSUMERS);
      mbar_init(v_empty(s), N_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= N_CONSUMERS) {
    // ---- producer warpgroup: one lane issues every TMA load; the
    // warpgroup gives its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == N_CONSUMERS) {
      mbar_expect_tx(q_full, G::Q_BYTES);
      for (int c = 0; c < G::NCH; ++c)
        tma_load_4d(s_q + c * BQ * G::ROWB, &tm_q, q_full, c * G::CHUNK,
                    q_start, hi, bi);
      for (int i = 0; i < n_run; ++i) {
        const int st = i % STAGES, kt = kt_begin + i;
        // the first pass over the ring finds it empty
        const uint32_t free_parity = ((i / STAGES) & 1) ^ 1;
        mbar_wait_or_trap(k_empty(st), free_parity);
        mbar_expect_tx(k_full(st), G::KV_BYTES);
        for (int c = 0; c < G::NCH; ++c)
          tma_load_4d(s_k + st * G::KV_BYTES + c * BK * G::ROWB, &tm_k,
                      k_full(st), c * G::CHUNK, kt * BK, hi, bi);
        mbar_wait_or_trap(v_empty(st), free_parity);
        mbar_expect_tx(v_full(st), G::KV_BYTES);
        for (int c = 0; c < G::NCH; ++c)
          tma_load_4d(s_v + st * G::KV_BYTES + c * BK * G::ROWB, &tm_v,
                      v_full(st), c * G::CHUNK, kt * BK, hi, bi);
      }
      // wait until the consumers are done with the last tiles, so that
      // the time-out covers them too
      for (int i = max(n_run - STAGES, 0); i < n_run; ++i) {
        const uint32_t used_parity = (i / STAGES) & 1;
        mbar_wait_or_trap(k_empty(i % STAGES), used_parity);
        mbar_wait_or_trap(v_empty(i % STAGES), used_parity);
      }
    }
    return;
  }

  // ---- consumer warpgroups: S, O and P in registers (at d = 128, 64 + 64
  // + 32 a thread), more than the 168 an even split of 384 threads allows
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  // accumulator element i of this thread sits at row r0 + 8*((i>>1)&1),
  // column 8*(i/4) + cq + (i&1) of the warpgroup's 64-row tile
  const int r0 = (t / 32) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int q_lo = q_start + wg * 64;          // this warpgroup's rows
  const int q_hi = q_lo + 63;
  auto needs_mask = [&](int kt) {              // uniform over the warpgroup
    const int k_start = kt * BK;
    return k_start + BK > seq_k || (causal && k_start + BK - 1 > q_lo) ||
           (window && q_hi - k_start >= window);
  };
  auto issue_s = [&](float (&s)[BK / 2], int st) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n128(s, desc_kmajor<D>(s_q, BQ, wg * 64, kk),
                    desc_kmajor<D>(s_k + st * G::KV_BYTES, BK, 0, kk),
                    kk > 0);
    wgmma_commit();
  };

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF};
  float l_i[2] = {0.f, 0.f};                  // this thread's partial sums
  float s[BK / 2], alpha[2];
  uint32_t p[BK / 16][4];

  mbar_wait(q_full, 0);
  // Software pipeline within the warpgroup: tile i's S = Q K^T is issued
  // with tile i-1's O += P V behind it, and tile i's softmax runs while the
  // tensor cores finish P V. K's slot is freed when S is done, V's when
  // P V is.
  if (n_run > 0) {
    mbar_wait(k_full(0), 0);
    wgmma_fence();
    issue_s(s, 0);
    wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(k_empty(0));
    softmax_step(s, m_i, l_i, alpha, needs_mask(kt_begin), q_lo + r0,
                 kt_begin * BK + cq, seq_k, causal, window, scale_log2);
    to_fragments(s, p);
  }
  for (int i = 1; i < n_run; ++i) {
    const int st = i % STAGES, prev = (i - 1) % STAGES;
    mbar_wait(k_full(st), (i / STAGES) & 1);
    wgmma_fence();
    issue_s(s, st);
    mbar_wait(v_full(prev), ((i - 1) / STAGES) & 1);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D>(acc, p[kk], desc_mnmajor<D>(s_v + prev * G::KV_BYTES, kk));
    wgmma_commit();
    wgmma_wait<1>();                          // S done; P V may still run
    fence_regs(s);
    mbar_arrive(k_empty(st));
    softmax_step(s, m_i, l_i, alpha, needs_mask(kt_begin + i), q_lo + r0,
                 (kt_begin + i) * BK + cq, seq_k, causal, window,
                 scale_log2);
    wgmma_wait<0>();                          // P V done: acc and p free
    fence_regs(acc);
    mbar_arrive(v_empty(prev));
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];
    to_fragments(s, p);
  }
  if (n_run > 0) {
    const int last = (n_run - 1) % STAGES;
    mbar_wait(v_full(last), ((n_run - 1) / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D>(acc, p[kk], desc_mnmajor<D>(s_v + last * G::KV_BYTES, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(v_empty(last));
  }

  // ---- epilogue: divide, round to bf16, stage in this warpgroup's Q rows,
  // store 16-byte vectors
  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    denom[r] = fmaxf(l, 1e-30f);
    // the natural-log logsumexp of the scaled row: m_i is in base 2
    const int qpos = q_lo + r0 + 8 * r;
    if (lse != nullptr && lane % 4 == 0 && qpos < seq_q)
      lse[static_cast<long long>(bh) * seq_q + qpos] =
          (m_i[r] + log2f(denom[r])) * LN2;
  }
  // generic writes into rows the async proxy (TMA, wgmma) used before
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < D / 2; j += 2) {
    const int r = (j >> 1) & 1;
    const int row = wg * 64 + r0 + 8 * r;
    const int col = 8 * (j / 4) + cq;
    *reinterpret_cast<uint32_t*>(smem + swz_offset(BQ, G::ROWB, row, col)) =
        pack_bf16(acc[j] / denom[r], acc[j + 1] / denom[r]);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  // 16-byte groups a row: head_dim / 8 of the tile's D / 8 hold output
  const int groups = head_dim / 8;
  for (int idx = t; idx < 64 * groups; idx += 128) {
    const int row = wg * 64 + idx / groups;
    const int col = (idx % groups) * 8;
    const int qpos = q_start + row;
    if (qpos >= seq_q) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(
        smem + swz_offset(BQ, G::ROWB, row, col));
    *reinterpret_cast<uint4*>(o + bi * os.b + hi * os.h + qpos * os.s + col) =
        val;
  }
}

// ---- single-tile checks of the two products, for the card tests

// S (64 x 128, f32) = Q (64 x D) K^T, K (128 x D): both operands from
// TMA-loaded swizzled shared memory, as in the attention kernel
template <int D>
__global__ void __launch_bounds__(128)
    qk_tile_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   float* __restrict__ out) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t s_q = smem_addr(smem);
  const uint32_t s_k = s_q + G::Q_BYTES;     // Q tile sized for BQ rows
  const uint32_t bar = s_k + G::KV_BYTES;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // a box counts all its bytes, rows past the tensor's 64 (zeros) too
    mbar_expect_tx(bar, G::Q_BYTES + G::KV_BYTES);
    for (int c = 0; c < G::NCH; ++c) {
      tma_load_4d(s_q + c * BQ * G::ROWB, &tm_q, bar, c * G::CHUNK, 0, 0, 0);
      tma_load_4d(s_k + c * BK * G::ROWB, &tm_k, bar, c * G::CHUNK, 0, 0, 0);
    }
  }
  mbar_wait(bar, 0);
  float s[BK / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n128(s, desc_kmajor<D>(s_q, BQ, 0, kk),
                  desc_kmajor<D>(s_k, BK, 0, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  const int t = threadIdx.x, lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4, cq = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < BK / 2; ++j)
    out[(r0 + 8 * ((j >> 1) & 1)) * BK + 8 * (j / 4) + cq + (j & 1)] = s[j];
}

// O (64 x head_dim, f32) = P (64 x 128, bf16, row-major in global memory,
// read into A fragments) V, V (128 x head_dim) from TMA-loaded shared
// memory as the MN-major B operand (columns head_dim..D-1 zero-filled)
template <int D>
__global__ void __launch_bounds__(128)
    pv_tile_kernel(const __nv_bfloat16* __restrict__ pg,
                   const __grid_constant__ CUtensorMap tm_v,
                   float* __restrict__ out, int head_dim) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t s_v = smem_addr(smem);
  const uint32_t bar = s_v + G::KV_BYTES;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, G::KV_BYTES);
    for (int c = 0; c < G::NCH; ++c)
      tma_load_4d(s_v + c * BK * G::ROWB, &tm_v, bar, c * G::CHUNK, 0, 0, 0);
  }
  const int t = threadIdx.x, lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4, cq = 2 * (lane % 4);
  auto pair = [&](int row, int col) {
    const __nv_bfloat162 v =
        *reinterpret_cast<const __nv_bfloat162*>(pg + row * BK + col);
    return *reinterpret_cast<const uint32_t*>(&v);
  };
  uint32_t p[BK / 16][4];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    p[kk][0] = pair(r0, 16 * kk + cq);
    p[kk][1] = pair(r0 + 8, 16 * kk + cq);
    p[kk][2] = pair(r0, 16 * kk + 8 + cq);
    p[kk][3] = pair(r0 + 8, 16 * kk + 8 + cq);
  }
  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
  mbar_wait(bar, 0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<D>(acc, p[kk], desc_mnmajor<D>(s_v, kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int j = 0; j < D / 2; ++j) {
    const int col = 8 * (j / 4) + cq + (j & 1);
    if (col < head_dim)
      out[(r0 + 8 * ((j >> 1) & 1)) * head_dim + col] = acc[j];
  }
}

// ---- host side

// A (b, h, s, d) bf16 tensor as a 4-D TMA map, innermost first, with boxes
// of (CHUNK columns, `rows` rows) swizzled for wgmma. strides: b, h, s in
// elements (multiples of 8), d contiguous; d <= D, and the columns d..D-1
// of a box are out of bounds (zero-filled).
template <int D>
int make_map(CUtensorMap* map, const void* base, int b, int h, int s, int d,
             const long long* strides, int rows) {
  using G = Geo<D>;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t gstrides[3] = {static_cast<cuuint64_t>(strides[2]) * 2,
                                  static_cast<cuuint64_t>(strides[1]) * 2,
                                  static_cast<cuuint64_t>(strides[0]) * 2};
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
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int h, int seq_q, int seq_k, int d, int causal, int window,
           float scale, const long long* st, cudaStream_t stream) {
  using G = Geo<D>;
  CUtensorMap mq, mk, mv;
  int err = make_map<D>(&mq, q, b, h, seq_q, d, st, BQ);
  if (!err) err = make_map<D>(&mk, k, b, h, seq_k, d, st + 3, BK);
  if (!err) err = make_map<D>(&mv, v, b, h, seq_k, d, st + 6, BK);
  if (err) return err;
  // the attribute holds per device: set it once on each
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !attr_set[dev]) {
    e = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G::ALLOC);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) attr_set[dev] = true;
  }
  const dim3 grid(b * h, (seq_q + BQ - 1) / BQ);
  const OutStrides os{st[9], st[10], st[11]};
  flash_fwd_wgmma_kernel<D><<<grid, N_THREADS, G::ALLOC, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), os, lse, h, seq_q, seq_k, d,
      causal, window, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tile(int which, const void* a, const void* bt, void* out, int d,
                cudaStream_t stream) {
  using G = Geo<D>;
  const long long q_st[3] = {64LL * d, 64LL * d, d};
  const long long kv_st[3] = {1LL * BK * d, 1LL * BK * d, d};
  CUtensorMap ma, mb;
  cudaError_t e;
  if (which == 0) {  // S = Q K^T
    int err = make_map<D>(&ma, a, 1, 1, 64, d, q_st, BQ);
    if (!err) err = make_map<D>(&mb, bt, 1, 1, BK, d, kv_st, BK);
    if (err) return err;
    const int smem = G::Q_BYTES + G::KV_BYTES + 64 + 1024;
    e = cudaFuncSetAttribute(qk_tile_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    qk_tile_kernel<D><<<1, 128, smem, stream>>>(ma, mb,
                                                static_cast<float*>(out));
  } else {  // O = P V
    int err = make_map<D>(&mb, bt, 1, 1, BK, d, kv_st, BK);
    if (err) return err;
    const int smem = G::KV_BYTES + 64 + 1024;
    e = cudaFuncSetAttribute(pv_tile_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    pv_tile_kernel<D><<<1, 128, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(a), mb, static_cast<float*>(out),
        d);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch_d(const void* q, const void* k, const void* v, void* o,
               float* lse, int b, int h, int seq_q, int seq_k, int d,
               int causal, int window, float scale, const long long* strides,
               cudaStream_t s) {
  if (b < 1 || h < 1 || seq_q < 1 || seq_k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 32:
      return launch<32>(q, k, v, o, lse, b, h, seq_q, seq_k, d, causal,
                        window, scale, strides, s);
    case 64:
      return launch<64>(q, k, v, o, lse, b, h, seq_q, seq_k, d, causal,
                        window, scale, strides, s);
    case 112:  // the 128 instance, columns 112-127 zero-filled by TMA
    case 128:
      return launch<128>(q, k, v, o, lse, b, h, seq_q, seq_k, d, causal,
                         window, scale, strides, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (b, h, seq_q, d), k and v: (b, h, seq_k, d), o: (b, h, seq_q, d), all
// bf16 with d contiguous, d in {32, 64, 112, 128}. strides: 12 element
// strides (b, h, s) of q, k, v and o, in that order; those of q, k and v
// multiples of 8 and their bases 16-byte aligned (TMA). Returns 0, a
// cudaError_t, or 9001 / 9100 + CUresult when the TMA descriptors cannot
// be made.
extern "C" int smlt_flash_attention_fwd_wgmma(const void* q, const void* k,
                                              const void* v, void* o, int b,
                                              int h, int seq_q, int seq_k,
                                              int d, int causal, int window,
                                              float scale,
                                              const long long* strides,
                                              void* stream) {
  return dispatch_d(q, k, v, o, nullptr, b, h, seq_q, seq_k, d, causal,
                    window, scale, strides,
                    static_cast<cudaStream_t>(stream));
}

// The same, also writing lse: (b, h, seq_q) f32 contiguous, the
// natural-log logsumexp of each query's scaled, masked scores (the
// backward's P = exp(scale q.k - lse)).
extern "C" int smlt_flash_attention_fwd_wgmma_lse(
    const void* q, const void* k, const void* v, void* o, float* lse, int b,
    int h, int seq_q, int seq_k, int d, int causal, int window, float scale,
    const long long* strides, void* stream) {
  return dispatch_d(q, k, v, o, lse, b, h, seq_q, seq_k, d, causal, window,
                    scale, strides, static_cast<cudaStream_t>(stream));
}

// One tile of either product, contiguous bf16 in, f32 out, BK = 128 keys,
// d in {32, 64, 112, 128}. which = 0: out (64, BK) = a (64, d) b^T with
// b (BK, d); which = 1: out (64, d) = a (64, BK) b with b (BK, d).
extern "C" int smlt_wgmma_tile(int which, const void* a, const void* b,
                               void* out, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_tile<32>(which, a, b, out, d, s);
    case 64: return launch_tile<64>(which, a, b, out, d, s);
    case 112:
    case 128: return launch_tile<128>(which, a, b, out, d, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
