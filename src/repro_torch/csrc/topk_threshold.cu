// K21: a 512-bin histogram of |x| over [0, hi), in one streaming pass.
//
// Replaces the TPU kernel repro/kernels/topk_threshold.py::_kernel
// (pallas_call in histogram_abs).  x is any shape, f32 or bf16, read flat;
// hi is an f32 scalar read on the device through a pointer (no host sync).
// Element v lands in bin
//   b = (int) (fminf(fmaxf(fabsf((float) v) / hi, 0.f), 0.99999988f) * 512.f)
// which is the reference's clip(|v| / hi, 0, 1 - 1e-7) * 512 cast to int32:
// IEEE division (no --use_fast_math, no reciprocal), 0.99999988f the f32
// rounding of 1 - 1e-7, truncation toward zero.  A NaN |v| / hi gives bin 0
// (fmaxf returns its other operand), as the reference's CPU run does: XLA
// converts NaN to int32 0.  Elements with |v| >= hi land in bin 511.
//
// Design.  Integer counts, so the result is bit-deterministic: each CTA
// keeps a uint32 histogram in shared memory (shared-memory atomics), then
// adds its nonzero bins into the (512,) uint64 output with integer atomics
// (integer addition is associative: any order gives the same counts); the
// wrapper converts to f32 once.  The reference accumulates its tile counts
// in f32, which stops being exact past 2^24 in one bin; this kernel is
// exact up to 2^64.  A grid-stride loop of 16-byte vector loads (4 f32 or
// 8 bf16 a thread a step) over the aligned body, a scalar loop over the
// tail, 64-bit indices throughout (n up to 352 M on the path).
//
// Bound on the H100 (3.35 TB/s): n * sizeof(T) bytes read once and 2 KB
// written; a few operations per element, so bytes bound it.  Skew is the
// realistic input: masked weights put most elements into bin 0 and the
// refinement pass of ops.topk_threshold puts almost all of them into bin
// 511, and shared-memory atomics on one address serialise within a warp.
// This first version does nothing about that (no per-warp private
// histograms, no __match_any_sync aggregation); PERF.md times the dense and
// the skewed case apart.
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBins = 512;
constexpr int kThreads = 256;

__device__ __forceinline__ float load_abs(const float* p, int64_t i) {
  return fabsf(p[i]);
}
__device__ __forceinline__ float load_abs(const __nv_bfloat16* p, int64_t i) {
  return fabsf(__bfloat162float(p[i]));
}

__device__ __forceinline__ void count(unsigned* hist, float a, float hi) {
  const float s = fminf(fmaxf(a / hi, 0.f), 0.99999988f);
  atomicAdd(&hist[static_cast<int>(s * 512.f)], 1u);
}

// the 16-byte vector of one step: 4 f32 or 8 bf16
__device__ __forceinline__ void count_vec(unsigned* hist, const float* p, int64_t v,
                                          float hi) {
  const float4 q = reinterpret_cast<const float4*>(p)[v];
  count(hist, fabsf(q.x), hi);
  count(hist, fabsf(q.y), hi);
  count(hist, fabsf(q.z), hi);
  count(hist, fabsf(q.w), hi);
}
__device__ __forceinline__ void count_vec(unsigned* hist, const __nv_bfloat16* p,
                                          int64_t v, float hi) {
  const uint4 q = reinterpret_cast<const uint4*>(p)[v];
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[j]);
    count(hist, fabsf(__low2float(h)), hi);
    count(hist, fabsf(__high2float(h)), hi);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
histogram_abs_kernel(const T* __restrict__ x, int64_t n, const float* __restrict__ lim,
                     unsigned long long* __restrict__ out) {
  __shared__ unsigned hist[kBins];
  for (int b = threadIdx.x; b < kBins; b += kThreads) hist[b] = 0u;
  __syncthreads();
  const float hi = __ldg(lim);
  constexpr int per = 16 / sizeof(T);
  const int64_t n_vec = n / per;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (int64_t v = first; v < n_vec; v += stride) count_vec(hist, x, v, hi);
  for (int64_t i = n_vec * per + first; i < n; i += stride) count(hist, load_abs(x, i), hi);
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += kThreads) {
    const unsigned c = hist[b];
    if (c) atomicAdd(&out[b], static_cast<unsigned long long>(c));
  }
}

template <typename T>
int launch(const void* x, long long n, const void* lim, void* out, int n_ctas,
           void* stream) {
  histogram_abs_kernel<T><<<n_ctas, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<int64_t>(n), static_cast<const float*>(lim),
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: n elements, 16-byte aligned; lim: one f32 on the device; out: 512
// uint64 counts, zeroed by the caller.
extern "C" int histogram_abs_f32(const void* x, long long n, const void* lim, void* out,
                                 int n_ctas, void* stream) {
  return launch<float>(x, n, lim, out, n_ctas, stream);
}
extern "C" int histogram_abs_bf16(const void* x, long long n, const void* lim, void* out,
                                  int n_ctas, void* stream) {
  return launch<__nv_bfloat16>(x, n, lim, out, n_ctas, stream);
}
