// The fused SGD wgrad epilogue shared by K19/K20 (masked_matmul.cu) and
// K7/K8 (block_sparse_bwd.cu, block_sparse_grouped.cu): the new momentum
// m_new = mu * mom + x^T g + wd * w of one weight element, and the
// reference's stochastic rounding of it onto the bf16 grid.
#pragma once
#include "gemm_core.cuh"

namespace epi {

// mu * mom + acc + wd * w, left to right, no contraction: the reference's
// order of f32 operations (repro/kernels/*_matmul.py::_dw_fused_kernel).
template <typename TM, typename T>
__device__ __forceinline__ float momentum(float mu, TM mom, float acc, float wd, T w) {
  return __fadd_rn(__fadd_rn(__fmul_rn(mu, gemm::to_float(mom)), acc),
                   __fmul_rn(wd, gemm::to_float(w)));
}

// The reference's sr_to_bf16 on one f32 value: a murmur-style finaliser of
// gid ^ seed supplies 16 bits added below the bf16 mantissa cut, then
// truncation (uint32 arithmetic wraps).  gid is the element's id
// (g * K + row) * N + col in wrapping uint32, g = 0 for a single matrix.
__device__ __forceinline__ float sr_to_bf16(float v, unsigned seed, unsigned gid) {
  if (!isfinite(v)) return v;
  unsigned h = gid ^ seed;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  const unsigned bits = __float_as_uint(v);
  return __uint_as_float((bits + (h & 0xFFFFu)) & 0xFFFF0000u);
}

__device__ inline unsigned element_id(size_t g, int K, int N, int row, int col) {
  return (static_cast<unsigned>(g) * static_cast<unsigned>(K) + static_cast<unsigned>(row)) *
             static_cast<unsigned>(N) + static_cast<unsigned>(col);
}

// K19/K20's last steps on the momentum mn = momentum(...): times the mask
// byte (an inf or NaN under a zero mask gives NaN, as the reference's (...)
// * mk), then sr_to_bf16 on the element's id gid when sr.
__device__ __forceinline__ float mask_sr(float mn, unsigned mask, unsigned seed, unsigned gid,
                                         int sr) {
  mn = __fmul_rn(mn, static_cast<float>(mask));
  return sr ? sr_to_bf16(mn, seed, gid) : mn;
}

// Two (four) consecutive elements as floats, one load aligned to its width
// (bf16 widens exactly by a shift of its bits; no local copy in memory).
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

}  // namespace epi
