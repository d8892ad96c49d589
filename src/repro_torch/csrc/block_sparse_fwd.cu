// Block-sparse forward matmul  y = x @ W  over the active (bk, bn) blocks of W.
//
// Replaces the TPU kernel repro/kernels/block_sparse_matmul.py::_fwd_kernel
// (pallas_call in _fwd_call).  W is described by its CSC pack (core/pack.py):
// idx[j, :cnt[j]] lists the active K-blocks of N-block column j, ascending.
//
// Design: one CTA of 8 warps per (N-block column j, m-tile of bm rows).  The
// CTA reads cnt[j] and idx[j, s] itself (the TPU kernel got them by scalar
// prefetch) and loops over its active blocks only, staging the x tile
// (bm, 16 or 32) and the weight slab (16 or 32, bn) in shared memory and
// multiplying with bf16 wmma 16x16x16 tiles into f32 accumulators held in
// registers (each warp owns up to 8 of the (bm/16)*(bn/16) output tiles).
// The epilogue rounds once to bf16.
//
// Traps handled here:
//  * a column with cnt[j] == 0 still writes its (zero) tile: the wrapper's
//    output comes from torch.empty;
//  * decode has M = capacity rows (e.g. 4); the wrapper pads them to bm = 16
//    and slices the padded rows off;
//  * at bm = bn = bk = 128 the x tile and the weight block are 32 KB each in
//    bf16, so bk is staged in slabs of 32 rows (27 KB of shared memory in
//    all, under the 48 KB static limit).
//
// Bound on the H100: decode (M = 16 padded rows) is weight-bandwidth-bound:
// it must read every active block once (nnz * bk * bn * 2 bytes) and does 16
// rows of work per weight byte, far below the ~295 flop/byte ridge.  Prefill
// (M = 512..1024) is closer to the ridge.  This first version is simple and
// right: synchronous loads, no cp.async/TMA pipeline and no wgmma; its time
// against the bound is recorded in PERF.md.
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSlab = 32;       // K rows staged per shared-memory slab
constexpr int kMaxTiles = 8;    // accumulator tiles per warp: bm*bn <= 128*128
constexpr int kXLd = kSlab + 8; // padded row strides (multiples of 8 elements)

__global__ void __launch_bounds__(kThreads)
block_sparse_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w,
                        const int* __restrict__ idx,
                        const int* __restrict__ cnt,
                        __nv_bfloat16* __restrict__ y,
                        int K, int N, int width, int bm, int bn, int bk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int w_ld = bn + 8;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // bm x kXLd
  __nv_bfloat16* ws = xs + bm * kXLd;                           // kSlab x w_ld
  float* scratch = reinterpret_cast<float*>(ws + kSlab * w_ld); // 8 x 16x16

  const int j = blockIdx.x;
  const int m0 = blockIdx.y * bm;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = bn / 16;
  const int tiles = (bm / 16) * n_tiles;
  const int slab = (bk % kSlab == 0) ? kSlab : 16;
  const int count = cnt[j];

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMaxTiles];
#pragma unroll
  for (int i = 0; i < kMaxTiles; ++i) wmma::fill_fragment(acc[i], 0.0f);

  for (int s = 0; s < count; ++s) {
    const int k0 = idx[j * width + s] * bk;
    for (int kc = 0; kc < bk; kc += slab) {
      __syncthreads();  // the previous slab is consumed
      const int xv = slab / 8;  // 16-byte vectors per staged x row
      for (int t = threadIdx.x; t < bm * xv; t += kThreads) {
        const int r = t / xv, c = (t % xv) * 8;
        *reinterpret_cast<uint4*>(xs + r * kXLd + c) =
            *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + kc + c);
      }
      const int wv = bn / 8;
      for (int t = threadIdx.x; t < slab * wv; t += kThreads) {
        const int r = t / wv, c = (t % wv) * 8;
        *reinterpret_cast<uint4*>(ws + r * w_ld + c) =
            *reinterpret_cast<const uint4*>(w + (size_t)(k0 + kc + r) * N + j * bn + c);
      }
      __syncthreads();
      for (int kk = 0; kk < slab; kk += 16) {
#pragma unroll
        for (int i = 0; i < kMaxTiles; ++i) {
          const int f = warp + i * kWarps;
          if (f < tiles) {
            const int fm = f / n_tiles, fn = f % n_tiles;
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
            wmma::load_matrix_sync(a, xs + fm * 16 * kXLd + kk, kXLd);
            wmma::load_matrix_sync(b, ws + kk * w_ld + fn * 16, w_ld);
            wmma::mma_sync(acc[i], a, b, acc[i]);
          }
        }
      }
    }
  }

  // Epilogue: each warp stages one 16x16 f32 tile at a time and writes bf16.
  float* tile = scratch + warp * 256;
#pragma unroll
  for (int i = 0; i < kMaxTiles; ++i) {
    const int f = warp + i * kWarps;
    if (f < tiles) {
      const int fm = f / n_tiles, fn = f % n_tiles;
      wmma::store_matrix_sync(tile, acc[i], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16, c = e % 16;
        y[(size_t)(m0 + fm * 16 + r) * N + j * bn + fn * 16 + c] =
            __float2bfloat16(tile[e]);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// x (Mp, K), w (K, N) bf16 row-major; idx (N/bn, width), cnt (N/bn,) int32;
// y (Mp, N) bf16.  The wrapper checks Mp % bm == 0, K % bk == 0,
// N % bn == 0, bm, bn, bk multiples of 16 up to 128, 16-byte alignment.
extern "C" int block_sparse_fwd(const void* x, const void* w, const void* idx,
                                const void* cnt, void* y, int Mp, int K, int N,
                                int width, int bm, int bn, int bk, void* stream) {
  const dim3 grid(N / bn, Mp / bm);
  const size_t smem = sizeof(__nv_bfloat16) * (bm * kXLd + kSlab * (bn + 8)) +
                      sizeof(float) * kWarps * 256;
  block_sparse_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const int*>(idx), static_cast<const int*>(cnt),
      static_cast<__nv_bfloat16*>(y), K, N, width, bm, bn, bk);
  return static_cast<int>(cudaGetLastError());
}
