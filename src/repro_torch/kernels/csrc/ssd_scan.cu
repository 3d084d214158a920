// Mamba2 SSD chunked scan, forward: y and the final state. Replaces the
// Pallas kernel src/repro/kernels/ssd_scan.py::_ssd_kernel.
//
// For one (batch, head), chunks of Q tokens run in order from S = 0:
//   seg   = cumsum(dt * A)                                  (Q,)
//   y     = ((C B^T) o exp(seg_i - seg_j))_{i>=j} @ (x * dt)
//           + exp(seg) * (C @ S) + D * x                    (Q, p)
//   S    <- S * exp(seg_last) + B^T @ (x * dt * exp(seg_last - seg))
// x, B, C and y are f32 or bf16 (one type); dt, A, D are f32 (the wrapper
// upcasts them); everything is computed in f32 and y is rounded once.
//
// What bounds it on an H100: at the scoring shape of mamba2-2.7b (b 8,
// s 2048, h 80, p 64, n 128, Q 256) one launch moves about 370 MB (x and y
// in bf16, B, C, dt, the f32 final state) and does about 1.1e11 FLOPs on
// the pairs the causal mask leaves, so the byte bound (3.35 TB/s) and the
// bf16 tensor-core bound (989 TFLOP/s) are both near 0.11 ms. This first
// kernel computes on the CUDA cores in f32, so operations bound it, far
// above that.
//
// Design. The TPU kernel keeps S in VMEM across a sequential grid axis and
// holds a whole 256 x 256 score block; neither carries over. Here one
// block of 256 threads owns one (batch, head) and walks its chunks in a
// loop, with S (n x p, f32) resident in shared memory. Within a chunk the
// queries and keys go in 64-row tiles and only the tiles on or below the
// diagonal are computed. Every product is a 64 x 64 output tile in which
// each thread owns a 4 x 4 register tile (rows ty + 16i, columns tx + 16j),
// reading its operands from shared memory. seg is one thread's sequential
// f32 sum, in the plain version's order. The decay is always
// exp(seg_i - seg_j) (never exp(seg_i) / exp(seg_j), which overflows on
// long chunks), and a masked entry is set to 0 without evaluating it.
//
// Layout. x and y are read and written in place as (b, s, h, p) and dt as
// (b, s, h); B and C are (b, s, n) views indexed by batch with their own
// strides, so nothing is transposed or broadcast over heads in device
// memory. C B^T depends only on (batch, chunk), not on the head, and is
// recomputed by each of the h blocks of a batch: sharing it across heads
// is the obvious next optimisation, not made here.
//
// Limits: p <= 64, n <= 256, and shared memory of (129n + 64(n + 1) +
// 64*64 + 64*80 + 2Q) floats within the 227 KB a block may have: 137,984
// bytes at n 128, Q 256, so one block runs on each SM.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;    // rows of a query / key / state tile
constexpr int NT = 256;     // threads per block, a 16 x 16 grid of 4 x 4 tiles
constexpr int MAX_P = 64;   // head dim held in one tile's columns
constexpr int MAX_N = 256;  // state size: at most 4 row tiles of S
constexpr int LD_X = TILE;       // pitch of the x*dt tile and of S
constexpr int LD_BT = TILE + 1;  // pitch of B^T (n rows x 64 keys)
constexpr int LD_P = TILE + 16;  // pitch of the score tile: rows 16 banks apart

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

// acc[i][j] += sum_k A[(ty + 16i) * lda + k] * Bm[k * ldb + tx + 16j]
__device__ __forceinline__ void mma_tile(const float* __restrict__ A, int lda,
                                         const float* __restrict__ Bm, int ldb,
                                         int K, int ty, int tx,
                                         float acc[4][4]) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bm[k * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
  }
}

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

struct Args {
  const void* x;      // (b, s, h, p)
  const float* dt;    // (b, s, h)
  const float* A;     // (h,)
  const void* B;      // (b, s, n), strides sbb, sbt, 1
  const void* C;      // (b, s, n), strides scb, sct, 1
  const float* D;     // (h,)
  void* y;            // (b, s, h, p)
  float* final_state; // (b, h, n, p)
  int s, h, p, n, Q;
  int64_t sbb, sbt, scb, sct;
};

template <typename T>
__global__ void __launch_bounds__(NT) ssd_scan_kernel(Args args) {
  extern __shared__ float smem[];
  const int n = args.n, p = args.p, Q = args.Q, h = args.h;
  float* S = smem;                          // n x LD_X
  float* Bt = S + n * LD_X;                 // n x LD_BT: B^T of a key tile
  float* Cs = Bt + n * LD_BT;               // TILE x (n + 1): a query tile of C
  float* X = Cs + TILE * (n + 1);           // TILE x LD_X: (scaled) x * dt
  float* P = X + TILE * LD_X;               // TILE x LD_P: masked scores
  float* seg = P + TILE * LD_P;             // Q
  float* dts = seg + Q;                     // Q
  const int ldc = n + 1;

  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh % h;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const float a_h = args.A[hi], d_h = args.D[hi];
  const T* xg = static_cast<const T*>(args.x);
  T* yg = static_cast<T*>(args.y);
  const T* Bg = static_cast<const T*>(args.B) + bi * args.sbb;
  const T* Cg = static_cast<const T*>(args.C) + bi * args.scb;
  const int64_t row_x = static_cast<int64_t>(h) * p;  // x stride between tokens
  const int n_tiles = (Q + TILE - 1) / TILE;

  for (int e = tid; e < n * LD_X; e += NT) S[e] = 0.f;

  for (int c0 = 0; c0 < args.s; c0 += Q) {
    const int64_t tok0 = static_cast<int64_t>(bi) * args.s + c0;
    // x at (token tok0 + r, head hi, column col)
    auto x_at = [&](int r, int col) {
      return to_f32(xg[(tok0 + r) * row_x + static_cast<int64_t>(hi) * p + col]);
    };
    for (int r = tid; r < Q; r += NT) dts[r] = args.dt[(tok0 + r) * h + hi];
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
      for (int r = 0; r < Q; ++r) {
        acc = __fadd_rn(acc, __fmul_rn(dts[r], a_h));  // no contraction
        seg[r] = acc;
      }
    }
    __syncthreads();

    // B^T of key tile kt into Bt; x * dt into X, times exp(seg_last - seg)
    // for the state update (zero past the chunk's end and past column p)
    auto load_key_tile = [&](int kt, bool to_end) {
      const int j0 = kt * TILE;
      for (int r = warp; r < TILE; r += NT / 32) {
        const int j = j0 + r;
        const bool ok = j < Q;
        for (int col = lane; col < n; col += 32)
          Bt[col * LD_BT + r] =
              ok ? to_f32(Bg[(c0 + j) * args.sbt + col]) : 0.f;
        const float decay = ok && to_end ? expf(seg[Q - 1] - seg[j]) : 1.f;
        for (int col = lane; col < LD_X; col += 32) {
          float v = 0.f;
          if (ok && col < p) {
            v = __fmul_rn(x_at(j, col), dts[j]);
            if (to_end) v = __fmul_rn(v, decay);
          }
          X[r * LD_X + col] = v;
        }
      }
    };

    // ---- outputs of this chunk, one 64-query tile at a time -------------
    for (int qt = 0; qt < n_tiles; ++qt) {
      const int i0 = qt * TILE;
      for (int r = warp; r < TILE; r += NT / 32) {
        const int i = i0 + r;
        for (int col = lane; col < n; col += 32)
          Cs[r * ldc + col] = i < Q ? to_f32(Cg[(c0 + i) * args.sct + col]) : 0.f;
      }
      float acc_y[4][4];
      zero(acc_y);
      for (int kt = 0; kt <= qt; ++kt) {
        load_key_tile(kt, false);
        __syncthreads();
        float sc[4][4];
        zero(sc);
        mma_tile(Cs, ldc, Bt, LD_BT, n, ty, tx, sc);  // C B^T
        const int j0 = kt * TILE;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ty + 16 * a;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int j = j0 + tx + 16 * b;
            float v = 0.f;
            if (i < Q && j <= i) v = sc[a][b] * expf(seg[i] - seg[j]);
            P[(ty + 16 * a) * LD_P + tx + 16 * b] = v;
          }
        }
        __syncthreads();
        mma_tile(P, LD_P, X, LD_X, TILE, ty, tx, acc_y);  // scores @ (x dt)
        __syncthreads();
      }
      float cs[4][4];
      zero(cs);
      mma_tile(Cs, ldc, S, LD_X, n, ty, tx, cs);  // C @ S, S at chunk start
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        if (i >= Q) continue;
        const float e = expf(seg[i]);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int col = tx + 16 * b;
          if (col >= p) continue;
          const float v = (acc_y[a][b] + e * cs[a][b]) + d_h * x_at(i, col);
          yg[(tok0 + i) * row_x + static_cast<int64_t>(hi) * p + col] =
              from_f32<T>(v);
        }
      }
      __syncthreads();  // Cs is reloaded by the next query tile
    }

    // ---- state update: S <- S * exp(seg_last) + B^T (x dt exp(...)) -----
    float acc_s[MAX_N / TILE][4][4];
#pragma unroll
    for (int t = 0; t < MAX_N / TILE; ++t) zero(acc_s[t]);
    for (int kt = 0; kt < n_tiles; ++kt) {
      load_key_tile(kt, true);
      __syncthreads();
#pragma unroll
      for (int t = 0; t < MAX_N / TILE; ++t) {
        if (t * TILE >= n) break;
        // rows of B^T past n are clamped; their sums are never stored
        const float* a = Bt + t * TILE * LD_BT;
#pragma unroll 4
        for (int k = 0; k < TILE; ++k) {
          float av[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = min(t * TILE + ty + 16 * i, n - 1) - t * TILE;
            av[i] = a[row * LD_BT + k];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = X[k * LD_X + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc_s[t][i][j] += av[i] * bv[j];
        }
      }
      __syncthreads();
    }
    const float e_last = expf(seg[Q - 1]);
#pragma unroll
    for (int t = 0; t < MAX_N / TILE; ++t) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int row = t * TILE + ty + 16 * a;
        if (row >= n) continue;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int col = tx + 16 * b;
          S[row * LD_X + col] = S[row * LD_X + col] * e_last + acc_s[t][a][b];
        }
      }
    }
    __syncthreads();
  }

  float* fs = args.final_state + static_cast<int64_t>(bh) * n * p;
  for (int e = tid; e < n * p; e += NT) fs[e] = S[(e / p) * LD_X + e % p];
}

size_t smem_bytes(int n, int Q) {
  return sizeof(float) *
         (static_cast<size_t>(n) * LD_X + static_cast<size_t>(n) * LD_BT +
          static_cast<size_t>(TILE) * (n + 1) + TILE * LD_X + TILE * LD_P +
          2 * static_cast<size_t>(Q));
}

template <typename T>
int launch(const Args& args, int grid, cudaStream_t stream) {
  const size_t smem = smem_bytes(args.n, args.Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T><<<grid, NT, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, B, C, y: dtype 0 = float32, 1 = bfloat16; dt, A, D, final_state: f32.
// x, dt, y, final_state are contiguous; B and C have unit stride in n and
// the given batch and token strides. s must be a multiple of chunk.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int smlt_ssd_scan(const void* x, const void* dt, const void* A,
                             const void* B, const void* C, const void* D,
                             void* y, void* final_state, int b, int s, int h,
                             int p, int n, int chunk, int64_t b_stride_batch,
                             int64_t b_stride_tok, int64_t c_stride_batch,
                             int64_t c_stride_tok, int dtype, void* stream) {
  if (b < 1 || s < 1 || h < 1 || p < 1 || p > MAX_P || n < 1 || n > MAX_N ||
      chunk < 1 || s % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes(n, chunk) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  Args args{x, static_cast<const float*>(dt), static_cast<const float*>(A),
            B, C, static_cast<const float*>(D), y,
            static_cast<float*>(final_state), s, h, p, n, chunk,
            b_stride_batch, b_stride_tok, c_stride_batch, c_stride_tok};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(args, b * h, st);
  if (dtype == 1) return launch<__nv_bfloat16>(args, b * h, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
