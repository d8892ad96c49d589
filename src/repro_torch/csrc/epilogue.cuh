// The epilogue policies of the kernels on the GEMM core: how a launch's f32
// sums become its outputs, at an unsplit CTA's store and in a split's merge.
// Shared by the masked matmuls K13-K20 (masked_matmul.cu) and the
// block-sparse wgrads K3/K6 and K7/K8 (block_sparse_bwd.cuh, in
// block_sparse_bwd.cu and block_sparse_grouped.cu): the sum rounded once
// (Out), times the mask byte (MaskedOut), or the fused SGD wgrad's new
// momentum m_new = mu * mom + x^T g + wd * w of one weight element
// (Momentum), with the reference's stochastic rounding of it onto the bf16
// grid.
#pragma once
#include "gemm_core.cuh"
#include "gemm_launch.cuh"

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

// Copy rows m0.. (BM of them, up to the extent rows) and columns n0.. (BN,
// up to the extent cols) of src (row stride ld from element plane0) into
// the shared-window address dst, rows LD elements apart, 16 bytes a copy;
// zeros past the extents.
template <class C, int LD, typename E>
__device__ __forceinline__ void stage_tile(uint32_t dst, const E* src, size_t plane0, int ld,
                                           int rows, int cols, int m0, int n0) {
  constexpr int kPer = 16 / sizeof(E), per_row = C::BN / kPer, n = C::BM * per_row;
  for (int c = threadIdx.x; c < n; c += C::kThreads) {
    const int r = c / per_row, col = (c % per_row) * kPer;
    const bool ok = m0 + r < rows && n0 + col < cols;
    ptx::cp_async16(dst + (r * LD + col) * sizeof(E),
                    src + (ok ? plane0 + (size_t)(m0 + r) * ld + n0 + col : 0), ok);
  }
}

// The policies.  Element i is the flat index into the (G, K, N) (or (G,
// rows, cols)) output.  pair(i, v0, v1, mb) stores i and i + 1 (i even)
// from a CTA's sums, mb the pair's two staged mask bytes (low byte at i;
// 0 where no mask is staged); quad(i, v) stores i..i + 3 (i a multiple of
// 4) from a split merge's ordered sums, reading the mask bytes itself;
// before an unsplit CTA's store, fold<C>(warp, plane0, ld, rows, cols, m0,
// n0, smem) runs after its walk of the tile at (m0, n0) of the group whose
// outputs start at plane0 (row stride ld; rows and cols the extents the
// store clips at), the ring's shared memory free.
template <typename T>
struct Out {  // K13, K14, K16, K17, K3, K6: the sum, rounded once
  T* out;
  template <class C>
  __device__ __forceinline__ void fold(gemm::Warp<C>&, size_t, int, int, int, int, int,
                                       unsigned char*) const {}
  __device__ __forceinline__ void pair(size_t i, float v0, float v1, unsigned) const {
    gemm::store2(out + i, v0, v1);
  }
  __device__ __forceinline__ void quad(size_t i, float4 v) const { gemm::store4(out + i, v); }
};

template <typename T>
struct MaskedOut {  // K15, K18: the sum times the mask byte, rounded once
  T* out;
  const uint8_t* m;
  template <class C>
  __device__ __forceinline__ void fold(gemm::Warp<C>&, size_t, int, int, int, int, int,
                                       unsigned char*) const {}
  __device__ __forceinline__ void pair(size_t i, float v0, float v1, unsigned mb) const {
    gemm::store2(out + i, v0 * static_cast<float>(mb & 0xffu),
                 v1 * static_cast<float>(mb >> 8));
  }
  __device__ __forceinline__ void quad(size_t i, float4 v) const {
    const uchar4 mb = *reinterpret_cast<const uchar4*>(m + i);
    v.x *= static_cast<float>(mb.x);
    v.y *= static_cast<float>(mb.y);
    v.z *= static_cast<float>(mb.z);
    v.w *= static_cast<float>(mb.w);
    gemm::store4(out + i, v);
  }
};

// The fused SGD wgrad: m_new = mu * mom + acc + wd * w, times the mask byte
// where kMasked (K19, K20: an inf or NaN under a zero mask gives NaN, as
// the reference's (...) * mk; K7, K8 have no mask, their block is live by
// construction), with sr rounded onto the bf16 grid on the id i (= (g * K
// + row) * N + col in wrapping uint32), stored in TO; w in T, mom in TM.
template <typename T, typename TM, typename TO, bool kMasked>
struct Momentum {
  TO* out;
  const uint8_t* m;  // unread without kMasked
  const T* w;
  const TM* mom;
  float mu, wd;
  unsigned seed;
  int sr;

  // The momentum mu * mom + acc + wd * w folded into the CTA's sums before
  // the store: reads only, so that every pair's reads can be in flight
  // together (a store between them might alias the next pair's mom or w).
  // Where both tiles fit in the ring's shared memory, the CTA copies them
  // there by 16-byte cp.async and the fold reads shared memory, not a
  // latency-bound pair of global loads per fragment (PERF.md has both
  // times); their rows LD = BN + 8 elements apart, so that a warp's pairs
  // (rows g, columns 2t) fall in distinct banks.  bf16 w with f32 mom does
  // not fit on either wgrad tile and reads global memory.
  template <class C>
  __device__ __forceinline__ void fold(gemm::Warp<C>& warp, size_t plane0, int ld, int rows,
                                       int cols, int m0, int n0, unsigned char* smem) const {
    constexpr int LD = C::BN + 8;
    constexpr int W_BYTES = C::BM * LD * sizeof(T), MOM_BYTES = C::BM * LD * sizeof(TM);
    if constexpr (W_BYTES + MOM_BYTES <= C::SMEM) {
      __syncthreads();  // every warp is done with the ring
      const uint32_t base = ptx::smem_addr(smem);
      stage_tile<C, LD>(base, w, plane0, ld, rows, cols, m0, n0);
      stage_tile<C, LD>(base + W_BYTES, mom, plane0, ld, rows, cols, m0, n0);
      ptx::cp_async_commit();
      ptx::cp_async_wait_all();
      __syncthreads();
      const T* ws = reinterpret_cast<const T*>(smem);
      const TM* ms = reinterpret_cast<const TM*>(smem + W_BYTES);
      gemm::store(warp, rows, cols, m0, n0, [&](int r, int c, float& v0, float& v1) {
        const int j = (r - m0) * LD + c - n0;
        const float2 wv = load2(ws + j), mv = load2(ms + j);
        v0 = momentum(mu, mv.x, v0, wd, wv.x);
        v1 = momentum(mu, mv.y, v1, wd, wv.y);
      });
    } else {
      gemm::store(warp, rows, cols, m0, n0, [&](int r, int c, float& v0, float& v1) {
        const size_t i = plane0 + (size_t)r * ld + c;
        const float2 wv = load2(w + i), mv = load2(mom + i);
        v0 = momentum(mu, mv.x, v0, wd, wv.x);
        v1 = momentum(mu, mv.y, v1, wd, wv.y);
      });
    }
  }
  // the folded value's last steps: the mask byte (kMasked), sr, and the
  // caller's one rounding
  __device__ __forceinline__ float finish(float mn, unsigned mask, unsigned gid) const {
    if constexpr (kMasked) mn = __fmul_rn(mn, static_cast<float>(mask));
    return sr ? sr_to_bf16(mn, seed, gid) : mn;
  }
  __device__ __forceinline__ void pair(size_t i, float v0, float v1, unsigned mb) const {
    gemm::store2(out + i, finish(v0, mb & 0xffu, static_cast<unsigned>(i)),
                 finish(v1, mb >> 8, static_cast<unsigned>(i + 1)));
  }
  __device__ __forceinline__ float at(size_t i, float acc, float wv, float mv,
                                      unsigned mask) const {
    return finish(momentum(mu, mv, acc, wd, wv), mask, static_cast<unsigned>(i));
  }
  __device__ __forceinline__ void quad(size_t i, float4 v) const {
    uchar4 mb = make_uchar4(0, 0, 0, 0);
    if constexpr (kMasked) mb = *reinterpret_cast<const uchar4*>(m + i);
    const float4 wv = load4(w + i), mv = load4(mom + i);
    gemm::store4(out + i, make_float4(at(i, v.x, wv.x, mv.x, mb.x),
                                      at(i + 1, v.y, wv.y, mv.y, mb.y),
                                      at(i + 2, v.z, wv.z, mv.z, mb.z),
                                      at(i + 3, v.w, wv.w, mv.w, mb.w)));
  }
};

// The policy of one fused entry (m null without kMasked).
template <typename T, typename TM, typename TO, bool kMasked>
Momentum<T, TM, TO, kMasked> momentum_epi(const void* m, const void* w, const void* mom,
                                          void* out, unsigned seed, float mu, float wd,
                                          int sr) {
  return {static_cast<TO*>(out), static_cast<const uint8_t*>(m), static_cast<const T*>(w),
          static_cast<const TM*>(mom), mu, wd, seed, sr};
}

}  // namespace epi
