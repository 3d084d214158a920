// Shard aggregation, step 3 of SMLT's Fig. 5: out[i] = mean_w shards[w][i]
// for an (n, L) row-major stack. Replaces the Pallas kernel
// src/repro/kernels/hier_agg.py::_agg_kernel. A second entry,
// smlt_aggregate_and_apply, replaces _agg_apply_kernel: the same mean g,
// then out[i] = param_f32[i] - lr * g[i], rounded once to param's type
// (the reference bakes lr into the kernel; here it is an argument).
//
// What bounds it on an H100: bytes. It reads n*L elements and writes L, one
// add per element read, so it sits far below the card's ridge point; the
// least time is (n + 1) * L * sizeof(T) / 3.35 TB/s, and (n + 2) * L *
// sizeof(T) / 3.35 TB/s with the parameter read.
//
// Design: a grid-stride loop over L; each thread owns VEC consecutive
// elements (one 16-byte load per worker row, neighbouring threads on
// neighbouring addresses) and walks the worker rows in order 0..n-1,
// accumulating in f32. Then acc / n (an IEEE division: this file is built
// without fast math) and one rounding to the input type. The sum order and
// the division are the plain version's, so an f32 result equals it bit for
// bit. The apply step multiplies and subtracts with __fmul_rn / __fsub_rn,
// so no fused multiply-add changes its rounding either.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// APPLY = false: out = mean; APPLY = true: out = param - lr * mean
template <typename T, int VEC, bool APPLY>
__global__ void __launch_bounds__(256)
    agg_kernel(const T* __restrict__ shards, const T* __restrict__ param,
               T* __restrict__ out, int64_t n, int64_t L, float lr) {
  using P = Pack<T, VEC>;
  const int64_t nvec = L / VEC;
  const float fn = static_cast<float>(n);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nvec; i += stride) {
    float acc[VEC];
    const P first = reinterpret_cast<const P*>(shards)[i];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = to_f32(first.v[e]);
    for (int64_t w = 1; w < n; ++w) {
      const P x = reinterpret_cast<const P*>(shards + w * L)[i];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = acc[e] + to_f32(x.v[e]);
    }
    P y;
    if constexpr (APPLY) {
      const P w = reinterpret_cast<const P*>(param)[i];
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        y.v[e] = from_f32<T>(
            __fsub_rn(to_f32(w.v[e]), __fmul_rn(lr, acc[e] / fn)));
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) y.v[e] = from_f32<T>(acc[e] / fn);
    }
    reinterpret_cast<P*>(out)[i] = y;
  }
}

template <typename T, int VEC, bool APPLY>
int launch(const void* shards, const void* param, void* out, int64_t n,
           int64_t L, float lr, cudaStream_t stream) {
  const int threads = 256;
  const int64_t nvec = L / VEC;
  const int64_t want = (nvec + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  agg_kernel<T, VEC, APPLY><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(shards), static_cast<const T*>(param),
      static_cast<T*>(out), n, L, lr);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool APPLY>
int dispatch(const void* shards, const void* param, void* out, int64_t n,
             int64_t L, float lr, int dtype, cudaStream_t s) {
  if (n < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_ok = aligned16(shards) && aligned16(out) &&
                      (!APPLY || aligned16(param));
  if (dtype == 0) {
    if (vec_ok && L % 4 == 0)
      return launch<float, 4, APPLY>(shards, param, out, n, L, lr, s);
    return launch<float, 1, APPLY>(shards, param, out, n, L, lr, s);
  }
  if (dtype == 1) {
    if (vec_ok && L % 8 == 0)
      return launch<__nv_bfloat16, 8, APPLY>(shards, param, out, n, L, lr, s);
    return launch<__nv_bfloat16, 1, APPLY>(shards, param, out, n, L, lr, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (shards, param and out alike). Each
// returns cudaGetLastError() after the launch (0 on success).
extern "C" int smlt_aggregate_shards(const void* shards, void* out, int64_t n,
                                     int64_t L, int dtype, void* stream) {
  return dispatch<false>(shards, nullptr, out, n, L, 0.f, dtype,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int smlt_aggregate_and_apply(const void* shards, const void* param,
                                        void* out, int64_t n, int64_t L,
                                        float lr, int dtype, void* stream) {
  return dispatch<true>(shards, param, out, n, L, lr, dtype,
                        static_cast<cudaStream_t>(stream));
}
