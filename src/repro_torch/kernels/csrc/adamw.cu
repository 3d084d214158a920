// AdamW's update and the clip's sum of squares, one leaf a launch.
// Replaces no TPU kernel: the reference's src/repro/optim/adamw.py is plain
// jnp that XLA fuses into one pass a leaf, which eager PyTorch does not do
// (its plain version here runs about twenty elementwise kernels a leaf,
// each reading and writing f32 tensors the size of the parameter).
//
// smlt_adamw_update computes, for every element and in this order, the
// f32 expressions of the plain version (kernels/adamw.py's
// plain_adamw_update, formerly optim/adamw.py's upd) as PyTorch runs them
// on a CUDA tensor:
//   g = g * scale                      (scale read on the device, or 1)
//   m = b1 * m + (1 - b1) * g          (written in place)
//   v = b2 * v + (1 - b2) * (g * g)    (written in place)
//   d = (m * (1 / bc1)) / (sqrt(v * (1 / bc2)) + eps) + wd * p
//   out = p - lr * d                   (rounded once to p's type)
// PyTorch divides a CUDA tensor by a Python scalar as a multiplication by
// the scalar's reciprocal (taken in double, rounded to f32), so m / bc1 and
// v / bc2 are so computed here too. Each step is one IEEE operation (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn), so no fused multiply-add changes a rounding: the moments
// and the new parameters are bit-equal to the plain version's on the card.
// The scalars come in as the f32 values PyTorch would use: 1 - b1,
// 1 - b2, 1 / bc1 and 1 / bc2 each taken in the host's double and rounded
// to f32. p and g are each f32 or bf16; m and v are f32.
//
// smlt_sum_squares gives the f32 sum of g * g over a leaf, for the global-
// norm clip. Each thread sums its elements' squares in double (a square of
// an f32 value is exact there); then every block reduces its threads in a
// fixed tree into one partial, and a single finishing block adds the
// partials in a fixed order. No atomics: a run repeats bit for bit.
//
// What bounds them on an H100: bytes. The update reads p, g, m, v and
// writes out, m, v: 2 * |p| + |g| + 16 bytes a parameter (22 for bf16 p
// and g) and one division and one square root per element, far below the
// card's ridge point. The sum of squares reads |g| bytes a parameter.
//
// Design: one vectorised streaming pass for each. A thread owns VEC = 8
// consecutive elements per step of a grid-stride loop: 16-byte loads of
// bf16 (one) or f32 (two) per tensor, neighbouring threads on neighbouring
// addresses, and it starts the loads of a few steps before their
// arithmetic. The update's grid fills every SM to the occupancy its
// registers allow, so enough bytes are in flight to reach device
// bandwidth; the sum of squares' grid is at most the partials buffer's
// length, which the caller gives (a constant: kernels/adamw.py's
// SUMSQ_BLOCKS), so its sum order does not depend on the card. Lengths that are not a
// multiple of VEC finish in a scalar tail; a pointer that is not 16-byte
// aligned sends the whole call to the scalar instance.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;
// vectors a thread loads before it computes: 3 for the update (288 bytes in
// flight a thread), 2 for the sum of squares; on an H100 at olmo-1b's
// leaves one vector at a time reached 84 % and 87 % of the byte bound,
// these 86 % and 88 %
constexpr int UPDATE_UNROLL = 3;
constexpr int SUMSQ_UNROLL = 2;

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

// VEC consecutive elements at x (16-byte aligned) as f32
__device__ __forceinline__ void load_vec(const float* x, float (&out)[VEC]) {
  const float4 a = reinterpret_cast<const float4*>(x)[0];
  const float4 b = reinterpret_cast<const float4*>(x)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* x,
                                         float (&out)[VEC]) {
  const uint4 a = reinterpret_cast<const uint4*>(x)[0];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int e = 0; e < VEC / 2; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* x, const float (&in)[VEC]) {
  reinterpret_cast<float4*>(x)[0] = make_float4(in[0], in[1], in[2], in[3]);
  reinterpret_cast<float4*>(x)[1] = make_float4(in[4], in[5], in[6], in[7]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* x,
                                          const float (&in)[VEC]) {
  uint4 a;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&a);
#pragma unroll
  for (int e = 0; e < VEC; ++e) h[e] = __float2bfloat16_rn(in[e]);
  reinterpret_cast<uint4*>(x)[0] = a;
}

// c1 = 1 - b1, c2 = 1 - b2; ibc1 = 1 / bc1, ibc2 = 1 / bc2
struct Hyper {
  float lr, b1, c1, b2, c2, ibc1, ibc2, eps, wd;
};

// one element of the update; m and v in place, returns the new parameter
__device__ __forceinline__ float adamw_one(float p, float g, float& m,
                                           float& v, float s, const Hyper& h) {
  g = __fmul_rn(g, s);
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(h.c1, g));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(h.c2, __fmul_rn(g, g)));
  const float denom = __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.ibc2)), h.eps);
  const float d = __fadd_rn(__fdiv_rn(__fmul_rn(m, h.ibc1), denom),
                            __fmul_rn(h.wd, p));
  return __fsub_rn(p, __fmul_rn(h.lr, d));
}

// U vectors at i, i + stride, ...: every load first, then the arithmetic
// and the stores
template <int U, typename P, typename G>
__device__ __forceinline__ void update_vectors(
    const P* __restrict__ p, const G* __restrict__ g, float* __restrict__ m,
    float* __restrict__ v, P* __restrict__ out, int64_t i, int64_t stride,
    float s, const Hyper& h) {
  float pf[U][VEC], gf[U][VEC], mf[U][VEC], vf[U][VEC];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t at = (i + u * stride) * VEC;
    load_vec(p + at, pf[u]);
    load_vec(g + at, gf[u]);
    load_vec(m + at, mf[u]);
    load_vec(v + at, vf[u]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t at = (i + u * stride) * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      pf[u][e] = adamw_one(pf[u][e], gf[u][e], mf[u][e], vf[u][e], s, h);
    store_vec(m + at, mf[u]);
    store_vec(v + at, vf[u]);
    store_vec(out + at, pf[u]);
  }
}

// VECTOR: the body in VEC-wide steps and a scalar tail; else all scalar
template <typename P, typename G, bool VECTOR>
__global__ void __launch_bounds__(THREADS)
    adamw_step_kernel(const P* __restrict__ p, const G* __restrict__ g,
                      float* __restrict__ m, float* __restrict__ v,
                      P* __restrict__ out, const float* __restrict__ scale,
                      int64_t n, Hyper h) {
  const float s = scale ? *scale : 1.f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  int64_t done = 0;
  if constexpr (VECTOR) {
    const int64_t nvec = n / VEC;
    int64_t i = tid;
    for (; i + (UPDATE_UNROLL - 1) * stride < nvec; i += UPDATE_UNROLL * stride)
      update_vectors<UPDATE_UNROLL>(p, g, m, v, out, i, stride, s, h);
    for (; i < nvec; i += stride)
      update_vectors<1>(p, g, m, v, out, i, stride, s, h);
    done = nvec * VEC;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    float mi = m[i], vi = v[i];
    const float y = adamw_one(to_f32(p[i]), to_f32(g[i]), mi, vi, s, h);
    m[i] = mi;
    v[i] = vi;
    out[i] = from_f32<P>(y);
  }
}

// a fixed-order sum of one double per thread over the block, in thread 0
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warp_sums[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  x = 0.0;
  if (warp == 0) {
    x = lane < THREADS / 32 ? warp_sums[lane] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
  }
  return x;
}

// adds the squares of U vectors at i, i + stride, ... to acc, in that order
template <int U, typename G>
__device__ __forceinline__ void sumsq_vectors(const G* __restrict__ g,
                                              int64_t i, int64_t stride,
                                              double& acc) {
  float x[U][VEC];
#pragma unroll
  for (int u = 0; u < U; ++u) load_vec(g + (i + u * stride) * VEC, x[u]);
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const double d = x[u][e];
      acc += d * d;
    }
}

template <typename G, bool VECTOR>
__global__ void __launch_bounds__(THREADS)
    sumsq_partials_kernel(const G* __restrict__ g, int64_t n,
                          double* __restrict__ partials) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  double acc = 0.0;
  int64_t done = 0;
  if constexpr (VECTOR) {
    const int64_t nvec = n / VEC;
    int64_t i = tid;
    for (; i + (SUMSQ_UNROLL - 1) * stride < nvec; i += SUMSQ_UNROLL * stride)
      sumsq_vectors<SUMSQ_UNROLL>(g, i, stride, acc);
    for (; i < nvec; i += stride) sumsq_vectors<1>(g, i, stride, acc);
    done = nvec * VEC;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    const double d = to_f32(g[i]);
    acc += d * d;
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(THREADS)
    sumsq_finish_kernel(const double* __restrict__ partials, int count,
                        float* __restrict__ out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < count; i += THREADS) acc += partials[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[0] = static_cast<float>(acc);
}

bool aligned16(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

int64_t work_blocks(int64_t n, bool vector) {
  const int64_t items = vector ? n / VEC + n % VEC : n;
  const int64_t want = (items + THREADS - 1) / THREADS;
  return want < 1 ? 1 : want;
}

template <typename P, typename G, bool VECTOR>
int launch_update(const void* p, const void* g, void* m, void* v, void* out,
                  const void* scale, int64_t n, const Hyper& h,
                  cudaStream_t stream) {
  auto kernel = adamw_step_kernel<P, G, VECTOR>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  const int64_t full = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t want = work_blocks(n, VECTOR);
  kernel<<<static_cast<int>(want < full ? want : full), THREADS, 0, stream>>>(
      static_cast<const P*>(p), static_cast<const G*>(g),
      static_cast<float*>(m), static_cast<float*>(v), static_cast<P*>(out),
      static_cast<const float*>(scale), n, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename P, typename G>
int update_vec_or_scalar(const void* p, const void* g, void* m, void* v,
                         void* out, const void* scale, int64_t n,
                         const Hyper& h, cudaStream_t s) {
  if (aligned16(p) && aligned16(g) && aligned16(m) && aligned16(v) &&
      aligned16(out))
    return launch_update<P, G, true>(p, g, m, v, out, scale, n, h, s);
  return launch_update<P, G, false>(p, g, m, v, out, scale, n, h, s);
}

template <typename G>
int launch_sumsq(const void* g, void* partials, int64_t max_blocks, void* out,
                 int64_t n, cudaStream_t stream) {
  const bool vector = aligned16(g);
  const int64_t want = work_blocks(n, vector);
  const int blocks = static_cast<int>(want < max_blocks ? want : max_blocks);
  double* parts = static_cast<double*>(partials);
  if (vector)
    sumsq_partials_kernel<G, true><<<blocks, THREADS, 0, stream>>>(
        static_cast<const G*>(g), n, parts);
  else
    sumsq_partials_kernel<G, false><<<blocks, THREADS, 0, stream>>>(
        static_cast<const G*>(g), n, parts);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sumsq_finish_kernel<<<1, THREADS, 0, stream>>>(parts, blocks,
                                                 static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. p, g, m, v and out hold n
// elements each, contiguous; m and v are float32 and updated in place; out
// has p's type; scale points to one float32 on the device, or is null for
// no clip. c1 = 1 - b1 and c2 = 1 - b2; ibc1 = 1 / bc1 and ibc2 = 1 / bc2,
// the bias corrections' reciprocals. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int smlt_adamw_update(const void* p, const void* g, void* m,
                                 void* v, void* out, const void* scale,
                                 int64_t n, float lr, float b1, float c1,
                                 float b2, float c2, float ibc1, float ibc2,
                                 float eps, float wd, int p_dtype, int g_dtype,
                                 void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const Hyper h{lr, b1, c1, b2, c2, ibc1, ibc2, eps, wd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_dtype == 0 && g_dtype == 0)
    return update_vec_or_scalar<float, float>(p, g, m, v, out, scale, n, h, s);
  if (p_dtype == 0 && g_dtype == 1)
    return update_vec_or_scalar<float, __nv_bfloat16>(p, g, m, v, out, scale,
                                                      n, h, s);
  if (p_dtype == 1 && g_dtype == 0)
    return update_vec_or_scalar<__nv_bfloat16, float>(p, g, m, v, out, scale,
                                                      n, h, s);
  if (p_dtype == 1 && g_dtype == 1)
    return update_vec_or_scalar<__nv_bfloat16, __nv_bfloat16>(
        p, g, m, v, out, scale, n, h, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[0] = sum of g[i]^2 as float32; partials holds partials_len doubles of
// working memory, and the partials kernel's grid is at most partials_len
// blocks (at most 2^31 - 1). Two launches: the block partials, then one
// finishing block.
extern "C" int smlt_sum_squares(const void* g, void* partials,
                                int64_t partials_len, void* out, int64_t n,
                                int dtype, void* stream) {
  if (n < 0 || partials_len < 1 || partials_len > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_sumsq<float>(g, partials, partials_len, out, n, s);
  if (dtype == 1)
    return launch_sumsq<__nv_bfloat16>(g, partials, partials_len, out, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
