// Mamba2 SSD chunked scan, forward, for bf16 on Hopper's tensor cores
// (wgmma), with the tiles fed by TMA. Replaces the Pallas kernel
// src/repro/kernels/ssd_scan.py::_ssd_kernel for bf16 x, B and C; f32
// stays on the CUDA-core kernel in ssd_scan.cu (on the tensor cores f32
// would run as TF32, which cannot hold the f32 tolerance).
//
// For one (batch, head), chunks of Q tokens run in order from S = 0:
//   seg   = cumsum(dt * A)                                      (Q,)
//   y     = (C B^T o exp(seg_i - seg_j) o dt_j)_{i>=j} @ x
//           + exp(seg) o (C @ S) + D * x                        (Q, p)
//   S    <- S * exp(seg_last) + (B o dt exp(seg_last - seg))^T @ x
// dt, A, D are f32 (the wrapper upcasts them); y is rounded once to bf16;
// the final state is f32.
//
// What bounds it on an H100: bytes. At mamba2-2.7b's scoring shape (b 8,
// s 2048, h 80, p 64, n 128, Q 256) the function reads x, B, C, dt and
// writes y and the f32 final state once: 370,147,808 bytes, 0.1105 ms at
// 3.35 TB/s; its least work, 65,047,363,584 FLOPs (C B^T once per batch
// and chunk), takes 0.066 ms at the 989 TFLOP/s bf16 rate. This kernel
// does 193,273,528,320 FLOPs there: C B^T once per head, whole 64 x 64
// tiles on the diagonal, and the three f32 operands as two bf16 products
// each (below), 0.195 ms at the bf16 rate.
//
// Numerics. P = C B^T o decay o dt, the state at a chunk's start (S^) and
// the decayed B^T of the state update are f32 values. Each goes to the
// tensor cores as hi = bf16(v) and lo = bf16(v - hi), two products into
// one f32 accumulator, so it keeps about 16 bits; x, B and C are bf16
// already and go in exactly. One bf16 rounding of P alone puts y past the
// reference's 5e-2 tolerance (1.23x in tests/test_torch_ssd_numerics.py;
// 1.76x without dt folded into P), since C B^T is of size sqrt(n) and y
// a signed sum that cancels. The decay is always exp(seg_i - seg_j)
// (never exp(seg_i) / exp(seg_j)), taken as 2^((seg_i - seg_j) log2 e)
// with factors below 2^-126 flushed to 0; entries above the diagonal are
// 0 and never evaluated; seg is one thread's sequential f32 sum in the
// plain version's order. Padded dt = 0 leaves the state unchanged. Built
// without fast math.
//
// Design, against what held PR 12's CUDA-core kernel (ssd_scan.cu) at
// 1 % of its bound:
//  1. f32 products on the CUDA cores -> every product on wgmma, bf16 in,
//     f32 accumulate: G = C_i B_j^T (both K-major), Y_i += P_ij x_j (P from
//     registers, x the MN-major B operand), T = C_i S^ (S^ MN-major in
//     shared memory), S += (B o w)^T x (the decayed B^T from registers,
//     read transposed from the TMA-loaded B tile, x the MN-major B
//     operand; putting the decay on this side keeps it out of shared
//     memory). Within a warpgroup, key tile j's C B^T is issued with tile
//     j+1's P x behind it and its decay factors are computed while the
//     tensor cores run both; C S^ runs behind the last P x; the state
//     update builds the next tile's fragments under this one's product.
//  2. One 256-thread CTA per SM -> 384 threads: a producer warpgroup gives
//     its registers to two consumer warpgroups (setmaxnreg); the state
//     lives in the consumers' accumulators (64 state rows each, 32
//     registers a thread) for the whole walk and is written once.
//  3. Scalar loads with no overlap -> TMA loads the B, C and x tiles of a
//     chunk, 128-byte swizzled, into per-tile slots with full / empty
//     barriers. Each warpgroup walks its query tiles from the last and
//     frees a slot after its last use, and the producer refills the slots
//     of the next chunk in that order, so the high tiles load while the
//     consumers finish the low ones.
//  4. One thread's sequential seg between barriers -> the producer warp
//     loads dt (all lanes at once) and sums seg for the next chunk while
//     the consumers work on this one (double-buffered).
//  5. C B^T recomputed by each of the 80 heads -> kept: on the tensor
//     cores it costs 53.7 GFLOP in whole tiles (43.1 on the causal
//     pairs), ~0.054 ms at the bf16 rate; sharing it needs a 16.8 MB
//     scratch or CTAs over head groups.
//
// Layout of a CTA, for one (batch, head): the 64-token query tiles of a
// chunk are split so that each consumer warpgroup runs as many
// (query, key) tile pairs as the other (tiles {0, 3} and {1, 2} of a
// 256-token chunk). Per chunk each warpgroup writes its rows of S^ (split)
// to shared memory, scales its S by exp(seg_last), adds every key tile's
// update, then computes its query tiles' outputs; two named barriers order
// S^ between the warpgroups. Shared memory at Q = 256: C, B 4 x 16 KB
// each, x 4 x 8 KB, S^ 2 x 16 KB, seg and dt 2 x 2 KB, 199 KB in all.
// x, B and C are read through TMA maps of the model's own views (x as
// (b, s, h, p), B and C as (b, s, n) with any 16-byte multiple strides),
// so nothing is copied; columns past p and n are zero-filled by TMA.
// Limits: p <= 64, n <= 128, chunk a multiple of 64 up to 256 (at n 256 a
// chunk's B and C tiles alone would fill the 227 KB a CTA may have).
//
// The producer's barrier waits time out after 10 s and trap, so a lost
// barrier ends the launch with an error instead of hanging the card.
#include "hopper.cuh"

namespace {

constexpr int TILE = 64;        // tokens of a query / key tile; state rows of a warpgroup
constexpr int MAX_TILES = 4;    // chunk <= 256
constexpr int NPAD = 128;       // state size, padded: two 64-column chunks
constexpr int PPAD = 64;        // head dim, padded: one 64-column chunk
constexpr int ROWB = 128;       // bytes of a swizzled row (64 bf16)
constexpr int ATOM = 8 * ROWB;  // bytes of 8 swizzled rows
constexpr uint64_t SWIZZLE_128B = 1;            // wgmma descriptor layout
constexpr int CHUNK_BYTES = TILE * ROWB;        // one 64 x 64 bf16 box
constexpr int BC_BYTES = TILE * NPAD * 2;       // a B or C tile: 16 KB
constexpr int X_BYTES = TILE * PPAD * 2;        // an x tile: 8 KB
constexpr int SH_BYTES = NPAD * PPAD * 2;       // one half of S^: 16 KB
constexpr int N_CONSUMERS = 256;                // two warpgroups
// and a producer warpgroup, of which one warp works: all its 128 threads
// drop to 40 registers so that the consumers can rise to 232 (128 x
// (168 - 40) = 256 x (232 - 168))
constexpr int N_THREADS = N_CONSUMERS + 128;
constexpr int N_BARRIERS = 4 * MAX_TILES + 4;
constexpr float LOG2E = 1.4426950408889634f;

// Byte offsets from the 1024-aligned base of shared memory, for a chunk
// of nt tiles
struct Layout {
  int c, b, x, s_hi, s_lo, seg, dt, w, eseg, bar, alloc;
};

__host__ __device__ inline Layout layout(int nt) {
  Layout L;
  L.c = 0;
  L.b = L.c + nt * BC_BYTES;
  L.x = L.b + nt * BC_BYTES;
  L.s_hi = L.x + nt * X_BYTES;
  L.s_lo = L.s_hi + SH_BYTES;
  L.seg = L.s_lo + SH_BYTES;          // [2][Q] f32
  L.dt = L.seg + 2 * nt * TILE * 4;   // [2][Q] f32
  L.w = L.dt + 2 * nt * TILE * 4;     // [Q] f32: dt_j exp(seg_last - seg_j)
  L.eseg = L.w + nt * TILE * 4;       // [Q] f32: exp(seg_i)
  L.bar = L.eseg + nt * TILE * 4;
  L.alloc = L.bar + 8 * N_BARRIERS + 1024;  // + alignment
  return L;
}

// which consumer warpgroup owns query tile qt: {0, 3}, {1, 2}, {4, 7}, ...
__device__ __forceinline__ int owner(int qt) {
  return ((qt & 3) == 1 || (qt & 3) == 2) ? 1 : 0;
}

// K-major descriptor of k-step kk (16 of the NPAD columns) of a 64-row B
// or C tile stored as two 64-column chunks
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return make_desc(tile + (kk / 4) * CHUNK_BYTES + (kk % 4) * 32, 16, ATOM,
                   SWIZZLE_128B);
}

// MN-major descriptor of k-step kk (16 rows) of a `rows` x 64 tile: an x
// tile (keys x p) or S^ (state rows x p)
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int kk) {
  return make_desc(tile + kk * 16 * ROWB, rows * ROWB, ATOM, SWIZZLE_128B);
}

// (a, b) as hi = bf16 pairs and lo = bf16 pairs of the remainders
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float bf16_at(const uint8_t* p) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
}

// The accumulator element e of a 64 x 64 product sits, for this thread, at
// row r0 + 8 * ((e >> 1) & 1) and column 8 * (e >> 2) + cq + (e & 1)
__device__ __forceinline__ int acc_row(int r0, int e) {
  return r0 + 8 * ((e >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int cq, int e) {
  return 8 * (e >> 2) + cq + (e & 1);
}

// P (64 x 64, f32, accumulator layout) as hi and lo A fragments of 4
// k-steps: the accumulator layout of columns 16kk.. is the A layout of
// k-step kk
__device__ __forceinline__ void p_fragments(const float (&p)[32],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      split2(p[8 * kk + 2 * x], p[8 * kk + 2 * x + 1], hi[kk][x], lo[kk][x]);
}

// Y += (P_hi + P_lo) @ x: x (64 keys x 64) the MN-major B operand
__device__ __forceinline__ void px_product(float (&y)[32],
                                           const uint32_t (&hi)[4][4],
                                           const uint32_t (&lo)[4][4],
                                           uint32_t x_tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64(y, hi[kk], desc_mn(x_tile, TILE, kk));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64(y, lo[kk], desc_mn(x_tile, TILE, kk));
  wgmma_commit();
}

// G = C B^T: both 64 x NPAD tiles K-major
__device__ __forceinline__ void cb_product(float (&g)[32], uint32_t c_tile,
                                           uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < NPAD / 16; ++kk)
    wgmma_ss_n64<0>(g, desc_k(c_tile, kk), desc_k(b_tile, kk), kk > 0);
  wgmma_commit();
}

// T = C (S^_hi + S^_lo): C K-major, S^ (NPAD x 64) MN-major
__device__ __forceinline__ void cs_product(float (&t)[32], uint32_t c_tile,
                                           uint32_t s_hi, uint32_t s_lo) {
#pragma unroll
  for (int kk = 0; kk < NPAD / 16; ++kk)
    wgmma_ss_n64<1>(t, desc_k(c_tile, kk), desc_mn(s_hi, NPAD, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < NPAD / 16; ++kk)
    wgmma_ss_n64<1>(t, desc_k(c_tile, kk), desc_mn(s_lo, NPAD, kk), 1);
  wgmma_commit();
}

// This warpgroup's 64 state rows (accumulator layout) into S^, split:
// rows 64 wg.. of the NPAD x 64 hi and lo tiles, in TMA's 128-byte swizzle
__device__ __forceinline__ void store_state_split(const float (&s)[32],
                                                  uint8_t* s_hi,
                                                  uint8_t* s_lo, int wg,
                                                  int r0, int cq) {
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int off =
        swz_offset(NPAD, ROWB, TILE * wg + acc_row(r0, e), acc_col(cq, e));
    uint32_t hi, lo;
    split2(s[e], s[e + 1], hi, lo);
    *reinterpret_cast<uint32_t*>(s_hi + off) = hi;
    *reinterpret_cast<uint32_t*>(s_lo + off) = lo;
  }
}

// The A operand of this warpgroup's state update over one key tile,
// A[m][j] = B[j][64 wg + m] * w[j], read transposed from the TMA-loaded B
// tile and split into hi and lo fragments of 4 k-steps
__device__ __forceinline__ void state_fragments(const uint8_t* b_tile,
                                                const float* w, int wg,
                                                int r0, int cq,
                                                uint32_t (&hi)[4][4],
                                                uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int m = TILE * wg + r0 + 8 * (x & 1);
      const int j = 16 * kk + 8 * (x >> 1) + cq;
      const float v0 = bf16_at(b_tile + swz_offset(TILE, ROWB, j, m)) * w[j];
      const float v1 =
          bf16_at(b_tile + swz_offset(TILE, ROWB, j + 1, m)) * w[j + 1];
      split2(v0, v1, hi[kk][x], lo[kk][x]);
    }
}

// 2^x on the special-function unit, results below 2^-126 flushed to 0.
// exp2f without fast math takes a slower path to keep such subnormal
// results, and decays that small are common here (a chunk of 256 tokens
// decays by up to ~e^-128 in the reference's test distribution): on an
// H100 it made the whole kernel about 1.5x slower (chip_smoke.py phase
// 10 against a copy using exp2f). A factor below 2^-126 times
// |C B^T| ~ 10 and x ~ 1 is far below the tolerance.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The decay factors of query tile qt against key tile kt, in the
// accumulator layout: exp(seg_i - seg_j) dt_j on and below the diagonal, 0
// above it (never evaluated); the exponential as 2^((seg_i - seg_j) log2 e)
__device__ __forceinline__ void decay_factors(float (&d)[32], const float* seg,
                                              const float* dt, int qt, int kt,
                                              int r0, int cq) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int i = TILE * qt + acc_row(r0, e);
    const int j = TILE * kt + acc_col(cq, e);
    d[e] = (kt < qt || j <= i) ? exp2_ftz((seg[i] - seg[j]) * LOG2E) * dt[j]
                               : 0.f;
  }
}

struct Params {
  const float* dt;      // (b, s, h) f32, contiguous
  const float* A;       // (h,)
  const float* D;       // (h,)
  __nv_bfloat16* y;     // (b, s, h, p) bf16, contiguous
  float* final_state;   // (b, h, n, p) f32
  int s, h, p, n, nt;   // nt: 64-token tiles a chunk
};

__global__ void __launch_bounds__(N_THREADS, 1)
    ssd_scan_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                          const __grid_constant__ CUtensorMap tm_b,
                          const __grid_constant__ CUtensorMap tm_c, Params P) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const int nt = P.nt, Q = nt * TILE;
  const Layout L = layout(nt);
  const uint32_t base = smem_addr(smem);
  float* seg_s = reinterpret_cast<float*>(smem + L.seg);
  float* dt_s = reinterpret_cast<float*>(smem + L.dt);
  float* w_s = reinterpret_cast<float*>(smem + L.w);
  float* eseg_s = reinterpret_cast<float*>(smem + L.eseg);
  const uint32_t bar = base + L.bar;
  auto c_full = [&](int t) { return bar + 8 * t; };
  auto c_empty = [&](int t) { return bar + 8 * (MAX_TILES + t); };
  auto k_full = [&](int t) { return bar + 8 * (2 * MAX_TILES + t); };  // B and x
  auto k_empty = [&](int t) { return bar + 8 * (3 * MAX_TILES + t); };
  auto seg_full = [&](int u) { return bar + 8 * (4 * MAX_TILES + u); };
  auto seg_empty = [&](int u) { return bar + 8 * (4 * MAX_TILES + 2 + u); };

  const int bh = blockIdx.x;
  const int bi = bh / P.h, hi = bh % P.h;
  const int n_chunks = P.s / Q;
  const int n_loaded = (P.n + TILE - 1) / TILE;  // column chunks of B, C with data

  if (threadIdx.x == 0) {
    for (int t = 0; t < MAX_TILES; ++t) {
      mbar_init(c_full(t), 1);
      mbar_init(c_empty(t), 128);          // the owning warpgroup
      mbar_init(k_full(t), 1);
      mbar_init(k_empty(t), N_CONSUMERS);
    }
    for (int u = 0; u < 2; ++u) {
      mbar_init(seg_full(u), 1);
      mbar_init(seg_empty(u), N_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (n_loaded < 2) {
    // the second column chunk of the B and C tiles is never loaded: zeros
    for (int i = threadIdx.x; i < 2 * nt * CHUNK_BYTES / 16; i += N_THREADS) {
      const int tile = i / (CHUNK_BYTES / 16), v = i % (CHUNK_BYTES / 16);
      *reinterpret_cast<uint4*>(smem + L.c + tile * BC_BYTES + CHUNK_BYTES +
                                16 * v) = make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= N_CONSUMERS) {
    // ---- producer: one warp loads dt and sums seg a chunk ahead; its lane
    // 0 issues every TMA load. The other three warps leave.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x >= N_CONSUMERS + 32) return;
    const int lane = threadIdx.x - N_CONSUMERS;
    const float a_h = P.A[hi];
    for (int c = 0; c < n_chunks; ++c) {
      const int u = c & 1;
      const int tok0 = c * Q;
      // seg buffer u is free once the consumers are done with chunk c - 2
      if (lane == 0) mbar_wait_or_trap(seg_empty(u), ((c >> 1) & 1) ^ 1);
      __syncwarp();
      float* dtb = dt_s + u * Q;
      float* segb = seg_s + u * Q;
      const float* dtg =
          P.dt + (static_cast<long long>(bi) * P.s + tok0) * P.h + hi;
      // every lane issues its loads of the column at once; segb holds
      // dt * A until lane 0 sums it in place
      constexpr int PER_LANE = MAX_TILES * TILE / 32;
      float v[PER_LANE];
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k) {
        const int j = lane + 32 * k;
        v[k] = j < Q ? dtg[static_cast<long long>(j) * P.h] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k) {
        const int j = lane + 32 * k;
        if (j < Q) {
          dtb[j] = v[k];
          segb[j] = __fmul_rn(v[k], a_h);
        }
      }
      __syncwarp();
      if (lane == 0) {
        float acc = 0.f;                 // sequential, as the plain cumsum
#pragma unroll 4
        for (int j = 0; j < Q; j += 4) {
          float4 d = *reinterpret_cast<const float4*>(segb + j);
          d.x = acc = __fadd_rn(acc, d.x);
          d.y = acc = __fadd_rn(acc, d.y);
          d.z = acc = __fadd_rn(acc, d.z);
          d.w = acc = __fadd_rn(acc, d.w);
          *reinterpret_cast<float4*>(segb + j) = d;
        }
        mbar_arrive(seg_full(u));
        // the first pass finds every slot empty
        const uint32_t free_parity = (c & 1) ^ 1;
        // slots in the order the consumers free them: a warpgroup walks
        // its query tiles from the last, and is done with the high key
        // tiles first
        for (int t = nt - 1; t >= 0; --t) {
          const int tok = tok0 + t * TILE;
          mbar_wait_or_trap(c_empty(t), free_parity);
          mbar_expect_tx(c_full(t), n_loaded * CHUNK_BYTES);
          for (int ch = 0; ch < n_loaded; ++ch)
            tma_load_3d(base + L.c + t * BC_BYTES + ch * CHUNK_BYTES, &tm_c,
                        c_full(t), ch * TILE, tok, bi);
          mbar_wait_or_trap(k_empty(t), free_parity);
          mbar_expect_tx(k_full(t), n_loaded * CHUNK_BYTES + X_BYTES);
          for (int ch = 0; ch < n_loaded; ++ch)
            tma_load_3d(base + L.b + t * BC_BYTES + ch * CHUNK_BYTES, &tm_b,
                        k_full(t), ch * TILE, tok, bi);
          tma_load_4d(base + L.x + t * X_BYTES, &tm_x, k_full(t), 0, tok, hi,
                      bi);
        }
      }
      __syncwarp();
    }
    if (lane == 0) {
      // wait until the consumers are done with the last chunk, so that the
      // time-out covers them too
      const int c = n_chunks - 1;
      for (int t = 0; t < nt; ++t) {
        mbar_wait_or_trap(c_empty(t), c & 1);
        mbar_wait_or_trap(k_empty(t), c & 1);
      }
      mbar_wait_or_trap(seg_empty(c & 1), (c >> 1) & 1);
    }
    return;
  }

  // ---- consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const float d_h = P.D[hi];
  const uint32_t s_hi = base + L.s_hi, s_lo = base + L.s_lo;

  float S[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) S[e] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int u = c & 1;
    const uint32_t phase = c & 1;
    const long long tok0 = static_cast<long long>(bi) * P.s + c * Q;
    mbar_wait(seg_full(u), (c >> 1) & 1);
    const float* segb = seg_s + u * Q;
    const float* dtb = dt_s + u * Q;
    const float seg_last = segb[Q - 1];

    // S^ = the state at the chunk's start; then S <- S exp(seg_last)
    store_state_split(S, smem + L.s_hi, smem + L.s_lo, wg, r0, cq);
    const float e_last = expf(seg_last);
#pragma unroll
    for (int e = 0; e < 32; ++e) S[e] *= e_last;
    for (int j = threadIdx.x; j < Q; j += N_CONSUMERS) {
      w_s[j] = dtb[j] * expf(seg_last - segb[j]);
      eseg_s[j] = expf(segb[j]);
    }
    // generic writes of S^ before the tensor cores read it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(N_CONSUMERS) : "memory");

    // ---- state update over every key tile, from the last (the first to
    // be loaded again); the next tile's fragments are built while the
    // tensor cores run this one's
    {
      uint32_t ah[2][4][4], al[2][4][4];
      mbar_wait(k_full(nt - 1), phase);
      state_fragments(smem + L.b + (nt - 1) * BC_BYTES, w_s + (nt - 1) * TILE,
                      wg, r0, cq, ah[0], al[0]);
#pragma unroll
      for (int it = 0; it < MAX_TILES; ++it) {
        if (it < nt) {
          const int kt = nt - 1 - it;
          wgmma_fence();
          px_product(S, ah[it & 1], al[it & 1], base + L.x + kt * X_BYTES);
          if (kt > 0) {
            mbar_wait(k_full(kt - 1), phase);
            state_fragments(smem + L.b + (kt - 1) * BC_BYTES,
                            w_s + (kt - 1) * TILE, wg, r0, cq,
                            ah[(it + 1) & 1], al[(it + 1) & 1]);
          }
          wgmma_wait<0>();
          fence_regs(S);
        }
      }
    }
    // a key slot is freed by this warpgroup after its last use: the slots
    // above its highest query tile now, the others after the query tiles
    // that read them last (walking down)
    int top = nt - 1;
    while (top >= 0 && owner(top) != wg) --top;
    for (int kt = top + 1; kt < nt; ++kt) mbar_arrive(k_empty(kt));

    // ---- outputs of this warpgroup's query tiles, from the last
    for (int qt = top; qt >= 0; --qt) {
      if (owner(qt) != wg) continue;
      const uint32_t c_tile = base + L.c + qt * BC_BYTES;
      mbar_wait(c_full(qt), phase);
      float Y[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) Y[e] = 0.f;
      // key tiles from the diagonal down: tile kt's C B^T is issued with
      // the previous tile's P x behind it, and tile kt's decay factors are
      // computed while the tensor cores run both
      float G[32], dec[32];
      uint32_t phi[4][4], plo[4][4];
      wgmma_fence();
      cb_product(G, c_tile, base + L.b + qt * BC_BYTES);
      decay_factors(dec, segb, dtb, qt, qt, r0, cq);
      wgmma_wait<0>();
      fence_regs(G);
#pragma unroll
      for (int e = 0; e < 32; ++e) G[e] *= dec[e];
      p_fragments(G, phi, plo);
      for (int kt = qt - 1; kt >= 0; --kt) {
        wgmma_fence();
        cb_product(G, c_tile, base + L.b + kt * BC_BYTES);
        px_product(Y, phi, plo, base + L.x + (kt + 1) * X_BYTES);
        decay_factors(dec, segb, dtb, qt, kt, r0, cq);
        wgmma_wait<1>();                      // G done; P x may still run
        fence_regs(G);
#pragma unroll
        for (int e = 0; e < 32; ++e) G[e] *= dec[e];
        wgmma_wait<0>();                      // P x done: its fragments free
        fence_regs(Y);
        p_fragments(G, phi, plo);
      }
      float T[32];                             // C S^, behind the last P x
      wgmma_fence();
      px_product(Y, phi, plo, base + L.x);
      cs_product(T, c_tile, s_hi, s_lo);
      wgmma_wait<0>();
      fence_regs(Y);
      fence_regs(T);
      mbar_arrive(c_empty(qt));
      // y = (Y + exp(seg_i) T) + D x, rounded once; x from its tile
      const uint8_t* x_tile = smem + L.x + qt * X_BYTES;
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int r = acc_row(r0, e), col = acc_col(cq, e);
        if (col >= P.p) continue;
        const int i = TILE * qt + r;
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            x_tile + swz_offset(TILE, ROWB, r, col)));
        const float es = eseg_s[i];
        const float v0 = (Y[e] + es * T[e]) + d_h * xv.x;
        const float v1 = (Y[e + 1] + es * T[e + 1]) + d_h * xv.y;
        *reinterpret_cast<__nv_bfloat162*>(
            P.y + ((tok0 + i) * P.h + hi) * P.p + col) =
            __floats2bfloat162_rn(v0, v1);
      }
      int below = qt - 1;
      while (below >= 0 && owner(below) != wg) --below;
      for (int kt = below + 1; kt <= qt; ++kt) mbar_arrive(k_empty(kt));
    }
    mbar_arrive(seg_empty(u));
    // S^, w and exp(seg) are rewritten by the next chunk
    asm volatile("bar.sync 1, %0;\n" ::"n"(N_CONSUMERS) : "memory");
  }

  float* fs = P.final_state + static_cast<long long>(bh) * P.n * P.p;
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int row = TILE * wg + acc_row(r0, e), col = acc_col(cq, e);
    if (row < P.n && col < P.p)
      *reinterpret_cast<float2*>(fs + row * P.p + col) = make_float2(S[e], S[e + 1]);
  }
}

// ---- single-tile checks of the four products, for the card tests: each
// runs the kernel's own device code on TMA-loaded tiles (C and B 64 x
// NPAD, x 64 x 64, bf16, contiguous) and writes f32
//   which 0: out (64 x 64) = C B^T
//   which 1: out (64 x 64) = P x, P = f (64 x 64 f32), split
//   which 2: out (64 x 64) = C S^, S^ = f (NPAD x 64 f32), split
//   which 3: out (NPAD x 64) = (B o w)^T x, w = f (64 f32), split
__global__ void __launch_bounds__(N_CONSUMERS)
    ssd_tile_kernel(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_b,
                    const __grid_constant__ CUtensorMap tm_c,
                    const float* __restrict__ f, float* __restrict__ out,
                    int which) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t base = smem_addr(smem);
  const Layout L = layout(1);
  const uint32_t bar = base + L.bar;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, 2 * BC_BYTES + X_BYTES);
    for (int ch = 0; ch < 2; ++ch) {
      tma_load_3d(base + L.c + ch * CHUNK_BYTES, &tm_c, bar, ch * TILE, 0, 0);
      tma_load_3d(base + L.b + ch * CHUNK_BYTES, &tm_b, bar, ch * TILE, 0, 0);
    }
    tma_load_4d(base + L.x, &tm_x, bar, 0, 0, 0, 0);
  }
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4, cq = 2 * (lane % 4);
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  if (which == 2) {             // this warpgroup's rows of S^
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e)
      s[e] = f[(TILE * wg + acc_row(r0, e)) * PPAD + acc_col(cq, e)];
    store_state_split(s, smem + L.s_hi, smem + L.s_lo, wg, r0, cq);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  float* w_s = reinterpret_cast<float*>(smem + L.w);
  if (which == 3 && threadIdx.x < TILE) w_s[threadIdx.x] = f[threadIdx.x];
  __syncthreads();
  mbar_wait_or_trap(bar, 0);
  if (which == 3) {
    uint32_t ah[4][4], al[4][4];
    state_fragments(smem + L.b, w_s, wg, r0, cq, ah, al);
    wgmma_fence();
    px_product(acc, ah, al, base + L.x);
  } else if (wg == 0) {
    wgmma_fence();
    if (which == 0) {
      cb_product(acc, base + L.c, base + L.b);
    } else if (which == 1) {
      float p[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) p[e] = f[acc_row(r0, e) * TILE + acc_col(cq, e)];
      uint32_t phi[4][4], plo[4][4];
      p_fragments(p, phi, plo);
      wgmma_fence();
      px_product(acc, phi, plo, base + L.x);
    } else {
      cs_product(acc, base + L.c, base + L.s_hi, base + L.s_lo);
    }
  }
  if (which == 3 || wg == 0) {
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int e = 0; e < 32; ++e)
      out[(TILE * wg + acc_row(r0, e)) * 64 + acc_col(cq, e)] = acc[e];
  }
}

// ---- host side

// A bf16 tensor as a TMA map of `rank` dims (innermost first, contiguous
// innermost), boxes of 64 x 64 (and 1 in the outer dims), 128-byte
// swizzled; elements past a dim's end are read as zeros
int make_map(CUtensorMap* map, const void* base, int rank,
             const cuuint64_t* dims, const long long* strides) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  cuuint64_t gstrides[3];
  for (int i = 0; i < rank - 1; ++i)
    gstrides[i] = static_cast<cuuint64_t>(strides[i]) * 2;
  const cuuint32_t box[4] = {TILE, TILE, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
      dims, gstrides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + static_cast<int>(r);
}

// x as (p, s, h, b); B and C as (n, s, b); st: element strides x (b, s, h),
// B (b, s), C (b, s)
int make_maps(CUtensorMap* mx, CUtensorMap* mb, CUtensorMap* mc,
              const void* x, const void* B, const void* C, int b, int s,
              int h, int p, int n, const long long* st) {
  const cuuint64_t xd[4] = {static_cast<cuuint64_t>(p),
                            static_cast<cuuint64_t>(s),
                            static_cast<cuuint64_t>(h),
                            static_cast<cuuint64_t>(b)};
  const long long xs[3] = {st[1], st[2], st[0]};
  const cuuint64_t bd[3] = {static_cast<cuuint64_t>(n),
                            static_cast<cuuint64_t>(s),
                            static_cast<cuuint64_t>(b)};
  const long long bs[2] = {st[4], st[3]};
  const long long cs[2] = {st[6], st[5]};
  int err = make_map(mx, x, 4, xd, xs);
  if (!err) err = make_map(mb, B, 3, bd, bs);
  if (!err) err = make_map(mc, C, 3, bd, cs);
  return err;
}

// cudaFuncSetAttribute once per device and size
template <typename K>
int allow_smem(K kernel, int bytes) {
  static int set_to[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || set_to[dev] < bytes) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) set_to[dev] = bytes;
  }
  return 0;
}

}  // namespace

// x: (b, s, h, p), B and C: (b, s, n), all bf16 with the last dim
// contiguous, bases 16-byte aligned and the other strides (strides: 7
// element strides, x's b, s, h, then B's b, s and C's b, s) multiples of 8;
// dt: (b, s, h) f32 contiguous; A, D: (h,) f32; y: (b, s, h, p) bf16
// contiguous; final_state: (b, h, n, p) f32. p <= 64, n <= 128, chunk a
// multiple of 64 up to 256 dividing s. Returns 0, a cudaError_t, or 9001 /
// 9100 + CUresult when the TMA descriptors cannot be made.
extern "C" int smlt_ssd_scan_wgmma(const void* x, const void* dt,
                                   const void* A, const void* B,
                                   const void* C, const void* D, void* y,
                                   void* final_state, int b, int s, int h,
                                   int p, int n, int chunk,
                                   const long long* strides, void* stream) {
  if (b < 1 || s < 1 || h < 1 || p < 1 || p > PPAD || n < 1 || n > NPAD ||
      chunk < TILE || chunk > MAX_TILES * TILE || chunk % TILE != 0 ||
      s % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mb, mc;
  int err = make_maps(&mx, &mb, &mc, x, B, C, b, s, h, p, n, strides);
  if (err) return err;
  const int nt = chunk / TILE;
  const Layout L = layout(nt);
  err = allow_smem(ssd_scan_wgmma_kernel, L.alloc);
  if (err) return err;
  const Params prm{static_cast<const float*>(dt), static_cast<const float*>(A),
                   static_cast<const float*>(D), static_cast<__nv_bfloat16*>(y),
                   static_cast<float*>(final_state), s, h, p, n, nt};
  ssd_scan_wgmma_kernel<<<b * h, N_THREADS, L.alloc,
                          static_cast<cudaStream_t>(stream)>>>(mx, mb, mc, prm);
  return static_cast<int>(cudaGetLastError());
}

// One tile of one product (see ssd_tile_kernel): c, bm (64 x NPAD) and x
// (64 x 64) bf16 contiguous, f f32 contiguous, out f32 (64 or NPAD rows x
// 64).
extern "C" int smlt_ssd_wgmma_tile(int which, const void* c, const void* bm,
                                   const void* x, const void* f, void* out,
                                   void* stream) {
  if (which < 0 || which > 3) return static_cast<int>(cudaErrorInvalidValue);
  const long long st[7] = {TILE * PPAD, PPAD, PPAD, TILE * NPAD, NPAD,
                           TILE * NPAD, NPAD};
  CUtensorMap mx, mb, mc;
  int err = make_maps(&mx, &mb, &mc, x, bm, c, 1, TILE, 1, PPAD, NPAD, st);
  if (err) return err;
  const int smem = layout(1).alloc;
  err = allow_smem(ssd_tile_kernel, smem);
  if (err) return err;
  ssd_tile_kernel<<<1, N_CONSUMERS, smem, static_cast<cudaStream_t>(stream)>>>(
      mx, mb, mc, static_cast<const float*>(f), static_cast<float*>(out),
      which);
  return static_cast<int>(cudaGetLastError());
}
