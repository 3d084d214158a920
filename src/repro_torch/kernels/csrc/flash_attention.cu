// Causal / sliding-window attention forward with an online softmax, in
// f32 on the CUDA cores. Replaces the Pallas kernel
// src/repro/kernels/flash_attention.py::_flash_kernel for f32 inputs:
// kernels/flash_attention.py sends f32 here and bf16 to the tensor-core
// kernel in flash_attention_wgmma.cu (on the tensor cores f32 would run as
// TF32, which cannot hold the f32 tolerance of 2e-4 / 2e-5).
//
// Semantics held from the reference: q is scaled by d^-0.5 before the dot
// products; scores and the running (m, l, acc) are f32; masked scores are
// -1e30 (not -inf); a k-tile wholly above the causal diagonal or wholly
// outside the window is skipped (the rule of flash_attention.py:41-46 with
// this kernel's tile sizes); the output is acc / max(l, 1e-30). Keys at or
// past seq_k are masked like any other. q, k, v and o are read and written
// through their (b, h, s) strides with d contiguous, so transposed
// (b, s, h, d) views need no copy. Given an lse buffer it also stores
// each query's natural-log logsumexp, m + log(max(l, 1e-30)), for the
// backward in flash_attention_bwd.cu.
//
// What bounds it on an H100: operations, 4*b*h*d*s^2/2 causal FLOPs
// against the 67 TFLOP/s f32 rate of the CUDA cores. The f32 route serves
// the f32 wiring checks, not the bf16 main path.
//
// Design: one thread block of 256 threads per (b*h, 64-query tile). The
// scaled Q tile and each 64-key K/V tile are staged in shared memory as
// f32 (rows padded by one float so a warp's column reads hit distinct
// banks). Each thread owns a 4-row x (4 + D/16)-column register tile:
// 4x4 scores, then 4 x D/16 output accumulators; the 16 threads that share
// a row reduce its max and sum with warp shuffles. Dynamic shared memory
// (up to 115,200 bytes at d = 128) is enabled with cudaFuncSetAttribute.
// Head dims 32, 64, 112 and 128 each have an instance (D a multiple of 16).
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;   // queries per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block: 16 x 16
constexpr float NEG_INF = -1e30f;

struct Strides {  // elements; d is contiguous
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(BQ) * (D + 1) + static_cast<size_t>(BK) * (D + 1) +
          static_cast<size_t>(BK) * D + static_cast<size_t>(BQ) * BK);
}

template <int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, Strides st, int n_heads,
                     int seq_q, int seq_k,
                     int causal, int window, float scale) {
  constexpr int DP = D + 1;     // padded row stride of Qs / Ks
  constexpr int CPT = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x DP, scaled queries
  float* Ks = Qs + BQ * DP;     // BK x DP
  float* Vs = Ks + BK * DP;     // BK x D
  float* Ps = Vs + BK * D;      // BQ x BK, probabilities of this tile

  const int bh = blockIdx.x;
  const int bi = bh / n_heads, hi = bh % n_heads;
  // heaviest (last) query tiles first: causal work grows with the tile index
  const int q_start = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16;      // rows ty*4 .. ty*4+3
  const int tx = tid % 16;      // columns tx + 16*j
  const float* qb = q + bi * st.qb + hi * st.qh;
  const float* kb = k + bi * st.kb + hi * st.kh;
  const float* vb = v + bi * st.vb + hi * st.vh;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int qi = q_start + r;
    Qs[r * DP + c] =
        qi < seq_q ? qb[qi * st.qs + c] * scale : 0.f;
  }

  float acc[4][CPT];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = (seq_k + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k_start = kt * BK;
    // the reference's skip rule; both tests are uniform over the block
    if (causal && k_start > q_start + BQ - 1) break;
    if (window && k_start + BK - 1 < q_start - window + 1) continue;

    __syncthreads();  // the previous tile's Ks / Vs / Ps are consumed
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, c = idx % D;
      const int ki = k_start + r;
      const bool in = ki < seq_k;
      Ks[r * DP + c] = in ? kb[ki * st.ks + c] : 0.f;
      Vs[r * D + c] = in ? vb[ki * st.vs + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qpos = q_start + r;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k_start + tx + 16 * j;
        bool keep = kpos < seq_k;
        if (causal) keep = keep && qpos >= kpos;
        if (window) keep = keep && qpos - kpos < window;
        s[i][j] = keep ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 lanes holding row r are one half of a warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[r * BK + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = alpha * l_i[i] + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // Ps complete

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * BK + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = Vs[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q_start + ty * 4 + i;
    if (qpos >= seq_q) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
    // the natural-log logsumexp of the scaled row (all 16 lanes agree)
    if (lse != nullptr && tx == 0)
      lse[static_cast<long long>(bh) * seq_q + qpos] = m_i[i] + logf(denom);
    float* orow = o + bi * st.ob + hi * st.oh + qpos * st.os;
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[tx + 16 * c] = acc[i][c] / denom;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int h, int seq_q, int seq_k, int causal, int window, float scale,
           const Strides& st, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * h, (seq_q + BQ - 1) / BQ);
  flash_fwd_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, st, h, seq_q,
      seq_k, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_d(const void* q, const void* k, const void* v, void* o,
               float* lse, int b, int h, int seq_q, int seq_k, int d,
               int causal, int window, float scale, const Strides& st, cudaStream_t s) {
  switch (d) {
    case 32:
      return launch<32>(q, k, v, o, lse, b, h, seq_q, seq_k, causal, window,
                        scale, st, s);
    case 64:
      return launch<64>(q, k, v, o, lse, b, h, seq_q, seq_k, causal, window,
                        scale, st, s);
    case 112:  // zamba2-7b: 3584 / 32
      return launch<112>(q, k, v, o, lse, b, h, seq_q, seq_k, causal, window,
                         scale, st, s);
    case 128:
      return launch<128>(q, k, v, o, lse, b, h, seq_q, seq_k, causal, window,
                         scale, st, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (b, h, seq_q, d), k and v: (b, h, seq_k, d), o: (b, h, seq_q, d),
// each with d contiguous, d in {32, 64, 112, 128}; strides: 12 element
// strides (b, h, s) of q, k, v and o, in that order, all float32. lse:
// null, or (b, h, seq_q) f32 contiguous for the natural-log logsumexp of
// each query's scaled, masked scores (the backward's
// P = exp(scale q.k - lse)). Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int smlt_flash_attention_fwd_lse(const void* q, const void* k,
                                            const void* v, void* o,
                                            float* lse, int b, int h,
                                            int seq_q, int seq_k, int d,
                                            int causal, int window,
                                            float scale,
                                            const long long* strides,
                                            void* stream) {
  if (b < 1 || h < 1 || seq_q < 1 || seq_k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* x = strides;
  const Strides st{x[0], x[1], x[2], x[3], x[4],  x[5],
                   x[6], x[7], x[8], x[9], x[10], x[11]};
  return dispatch_d(q, k, v, o, lse, b, h, seq_q, seq_k, d, causal, window,
                    scale, st, s);
}

// The same with no lse.
extern "C" int smlt_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* o, int b, int h,
                                        int seq_q, int seq_k, int d,
                                        int causal, int window, float scale,
                                        const long long* strides,
                                        void* stream) {
  return smlt_flash_attention_fwd_lse(q, k, v, o, nullptr, b, h, seq_q,
                                      seq_k, d, causal, window, scale,
                                      strides, stream);
}
