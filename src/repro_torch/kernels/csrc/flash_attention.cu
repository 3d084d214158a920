// Causal / sliding-window attention forward with an online softmax.
// Replaces the Pallas kernel
// src/repro/kernels/flash_attention.py::_flash_kernel.
//
// Semantics held from the reference: q is scaled by d^-0.5 before the dot
// products; scores and the running (m, l, acc) are f32; masked scores are
// -1e30 (not -inf); a k-tile wholly above the causal diagonal or wholly
// outside the window is skipped (the rule of flash_attention.py:41-46 with
// this kernel's tile sizes); the output is acc / max(l, 1e-30), rounded
// once to the input type. Keys at or past seq_k are masked like any other.
//
// What bounds it on an H100: operations. At the training shape (b*h = 32,
// s = 2048, d = 128) a call does 4*b*h*d*s^2/2 causal FLOPs on 3 MB of bf16
// inputs, so the least time is set by the 989 TFLOP/s bf16 tensor-core
// rate. This first kernel runs on the CUDA cores in f32 (no wgmma, no TMA):
// it is correct and simple, and far from that bound.
//
// Design: one thread block of 256 threads per (b*h, 64-query tile). The
// scaled Q tile and each 64-key K/V tile are staged in shared memory as
// f32 (rows padded by one float so a warp's column reads hit distinct
// banks). Each thread owns a 4-row x (4 + D/16)-column register tile:
// 4x4 scores, then 4 x D/16 output accumulators; the 16 threads that share
// a row reduce its max and sum with warp shuffles. Dynamic shared memory
// (up to 115,200 bytes at d = 128) is enabled with cudaFuncSetAttribute.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;   // queries per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block: 16 x 16
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(BQ) * (D + 1) + static_cast<size_t>(BK) * (D + 1) +
          static_cast<size_t>(BK) * D + static_cast<size_t>(BQ) * BK);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int seq_q,
                     int seq_k, int causal, int window, float scale) {
  constexpr int DP = D + 1;     // padded row stride of Qs / Ks
  constexpr int CPT = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x DP, scaled queries
  float* Ks = Qs + BQ * DP;     // BK x DP
  float* Vs = Ks + BK * DP;     // BK x D
  float* Ps = Vs + BK * D;      // BQ x BK, probabilities of this tile

  const int bh = blockIdx.x;
  // heaviest (last) query tiles first: causal work grows with the tile index
  const int q_start = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16;      // rows ty*4 .. ty*4+3
  const int tx = tid % 16;      // columns tx + 16*j
  const T* qb = q + static_cast<size_t>(bh) * seq_q * D;
  const T* kb = k + static_cast<size_t>(bh) * seq_k * D;
  const T* vb = v + static_cast<size_t>(bh) * seq_k * D;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int qi = q_start + r;
    Qs[r * DP + c] =
        qi < seq_q ? to_f32(qb[static_cast<size_t>(qi) * D + c]) * scale : 0.f;
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
      const size_t off = static_cast<size_t>(ki) * D + c;
      Ks[r * DP + c] = in ? to_f32(kb[off]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vb[off]) : 0.f;
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
    T* orow = o + (static_cast<size_t>(bh) * seq_q + qpos) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[tx + 16 * c] = from_f32<T>(acc[i][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int seq_q, int seq_k, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (seq_q + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), seq_q, seq_k, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int bh,
               int seq_q, int seq_k, int d, int causal, int window,
               float scale, cudaStream_t s) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, bh, seq_q, seq_k, causal, window, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, o, bh, seq_q, seq_k, causal, window, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, bh, seq_q, seq_k, causal, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (bh, seq_q, d), k and v: (bh, seq_k, d), o: (bh, seq_q, d), all
// contiguous. dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int smlt_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* o, int bh,
                                        int seq_q, int seq_k, int d,
                                        int causal, int window, float scale,
                                        int dtype, void* stream) {
  if (bh < 1 || seq_q < 1 || seq_k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, bh, seq_q, seq_k, d, causal, window,
                             scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, bh, seq_q, seq_k, d, causal,
                                     window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
