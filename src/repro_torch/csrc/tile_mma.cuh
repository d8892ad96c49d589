// Tile products shared by the block-sparse kernels (K1 forward, K2 dgrad,
// K3 wgrad).  A CTA of 256 threads accumulates one (R x C) tile in f32, with
// R and C multiples of 16 up to 128, from slabs staged in shared memory as
// A (R x L, row-major, leading dimension lda) and B (L x C, row-major, ldb).
//
//  * bf16: wmma 16x16x16 on the tensor cores; warp w owns the output tiles
//    w, w + 8, ... of the (R/16) x (C/16) grid (at most 8 per warp).
//  * f32: FFMA on the CUDA cores, in full f32 (no TF32: it keeps ~3 digits,
//    not the reference's f32).  Thread (ty, tx) = (tid / 16, tid % 16) owns
//    rows ty + 16 i and columns tx + 16 j; per slab column l it reads 2
//    distinct A rows and 16 consecutive B columns per warp (broadcasts, no
//    bank conflicts with the f32 row pads below).
//
// Accumulation order is fixed (slab by slab, l ascending), so results are
// the same from run to run.
#pragma once
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace tile {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlab = 32;  // contraction rows staged per slab

// Row pad of a shared-memory slab, in elements: 16 bytes keeps rows 16-byte
// aligned for vector stores and (bf16) satisfies wmma's ld % 8 == 0.
template <typename T>
__host__ __device__ constexpr int pad() { return 16 / (int)sizeof(T); }

// Bytes of the per-warp f32 staging the bf16 epilogue needs (0 for f32).
template <typename T>
__host__ __device__ constexpr int epilogue_bytes() {
  return sizeof(T) == 2 ? kWarps * 256 * (int)sizeof(float) : 0;
}

__device__ inline float to_float(float v) { return v; }
__device__ inline float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ inline T from_float(float v);
template <> __device__ inline float from_float<float>(float v) { return v; }
template <> __device__ inline __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// dst[r * ldd + c] = src[r * lds + c] for r < rows, c < cols, 16 bytes per
// thread per step; cols * sizeof(T), lds and ldd rows must be 16-byte
// aligned (the wrappers check the global side).
template <typename T>
__device__ inline void stage_rows(T* dst, int ldd, const T* src, size_t lds,
                                  int rows, int cols) {
  constexpr int per = 16 / sizeof(T);
  const int vpr = cols / per;
  for (int t = threadIdx.x; t < rows * vpr; t += kThreads) {
    const int r = t / vpr, c = (t % vpr) * per;
    *reinterpret_cast<uint4*>(dst + r * ldd + c) =
        *reinterpret_cast<const uint4*>(src + r * lds + c);
  }
}

// Transposed staging: dst[c * ldd + r] = src[r * lds + c]; 16-byte reads,
// scalar shared-memory writes.
template <typename T>
__device__ inline void stage_cols(T* dst, int ldd, const T* src, size_t lds,
                                  int rows, int cols) {
  constexpr int per = 16 / sizeof(T);
  const int vpr = cols / per;
  for (int t = threadIdx.x; t < rows * vpr; t += kThreads) {
    const int r = t / vpr, c = (t % vpr) * per;
    uint4 raw = *reinterpret_cast<const uint4*>(src + r * lds + c);
    const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < per; ++e) dst[(c + e) * ldd + r] = vals[e];
  }
}

template <typename T> struct Acc;

template <> struct Acc<__nv_bfloat16> {
  static constexpr int kMaxTiles = 8;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[kMaxTiles];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < kMaxTiles; ++i) nvcuda::wmma::fill_fragment(acc[i], 0.0f);
  }

  // L must be a multiple of 16; A, B and their row strides 32-byte aligned.
  __device__ void mma(const __nv_bfloat16* A, int lda, const __nv_bfloat16* B,
                      int ldb, int R, int C, int L) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32;
    const int n_tiles = C / 16, tiles = (R / 16) * n_tiles;
    for (int kk = 0; kk < L; kk += 16) {
#pragma unroll
      for (int i = 0; i < kMaxTiles; ++i) {
        const int f = warp + i * kWarps;
        if (f < tiles) {
          const int fm = f / n_tiles, fn = f % n_tiles;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(a, A + fm * 16 * lda + kk, lda);
          wmma::load_matrix_sync(b, B + kk * ldb + fn * 16, ldb);
          wmma::mma_sync(acc[i], a, b, acc[i]);
        }
      }
    }
  }

  // st(r, c, value) for every element of the R x C tile; scratch holds
  // epilogue_bytes<bf16>() of shared memory, not aliased by live slabs.
  template <typename Store>
  __device__ void store(float* scratch, int R, int C, Store st) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int n_tiles = C / 16, tiles = (R / 16) * n_tiles;
    float* t = scratch + warp * 256;
#pragma unroll
    for (int i = 0; i < kMaxTiles; ++i) {
      const int f = warp + i * kWarps;
      if (f < tiles) {
        const int fm = f / n_tiles, fn = f % n_tiles;
        wmma::store_matrix_sync(t, acc[i], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) st(fm * 16 + e / 16, fn * 16 + e % 16, t[e]);
        __syncwarp();
      }
    }
  }
};

template <> struct Acc<float> {
  float c[8][8];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) c[i][j] = 0.0f;
  }

  __device__ void mma(const float* A, int lda, const float* B, int ldb, int R,
                      int C, int L) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    const int ri = R / 16, cj = C / 16;
    for (int l = 0; l < L; ++l) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = i < ri ? A[(ty + 16 * i) * lda + l] : 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = j < cj ? B[l * ldb + tx + 16 * j] : 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (i < ri && j < cj) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
  }

  template <typename Store>
  __device__ void store(float*, int R, int C, Store st) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (i < R / 16 && j < C / 16) st(ty + 16 * i, tx + 16 * j, c[i][j]);
  }
};

}  // namespace tile
