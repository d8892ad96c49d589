// The fused SGD wgrad epilogue shared by K19/K20 (masked_matmul.cu) and
// K7/K8 (block_sparse_bwd.cu, block_sparse_grouped.cu): the new momentum
// m_new = mu * mom + x^T g + wd * w of one weight element, and the
// reference's stochastic rounding of it onto the bf16 grid.
#pragma once
#include "tile_mma.cuh"

namespace epi {

// mu * mom + acc + wd * w, left to right, no contraction: the reference's
// order of f32 operations (repro/kernels/*_matmul.py::_dw_fused_kernel).
template <typename TM, typename T>
__device__ inline float momentum(float mu, TM mom, float acc, float wd, T w) {
  return __fadd_rn(__fadd_rn(__fmul_rn(mu, tile::to_float(mom)), acc),
                   __fmul_rn(wd, tile::to_float(w)));
}

// The reference's sr_to_bf16 on one f32 value: a murmur-style finaliser of
// gid ^ seed supplies 16 bits added below the bf16 mantissa cut, then
// truncation (uint32 arithmetic wraps).  gid is the element's id
// (g * K + row) * N + col in wrapping uint32, g = 0 for a single matrix.
__device__ inline float sr_to_bf16(float v, unsigned seed, unsigned gid) {
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

}  // namespace epi
