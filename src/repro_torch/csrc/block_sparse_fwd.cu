// Block-sparse forward matmul  y = x @ W  over the active (bk, bn) blocks of W.
//
// Replaces the TPU kernel repro/kernels/block_sparse_matmul.py::_fwd_kernel
// (pallas_call in _fwd_call).  W is described by its CSC pack (core/pack.py):
// idx[j, :cnt[j]] lists the active K-blocks of N-block column j, ascending.
//
// Design: one CTA of 8 warps per (N-block column j, m-tile of bm rows).  The
// CTA reads cnt[j] and idx[j, s] itself (the TPU kernel got them by scalar
// prefetch) and loops over its active blocks only, staging the x tile
// (bm x 16 or 32) and the weight slab (16 or 32 x bn) in shared memory and
// accumulating in f32 (tile_mma.cuh): bf16 on the tensor cores (wmma
// 16x16x16), f32 in full-precision FFMA, as the reference's f32 MLP
// computes.  The epilogue rounds once to the element type.
//
// Traps handled here:
//  * a column with cnt[j] == 0 still writes its (zero) tile: the wrapper's
//    output comes from torch.empty;
//  * decode has M = capacity rows (e.g. 4); the wrapper pads them to bm = 16
//    and slices the padded rows off;
//  * at bm = bn = bk = 128 a whole x tile and weight block would need 64 KB
//    (bf16) or 128 KB (f32), so bk is staged in slabs of 32 rows (27 KB in
//    bf16, 35 KB in f32).
//
// Bound on the H100: decode (M = 16 padded rows) is weight-bandwidth-bound:
// it must read every active block once (nnz * bk * bn * sizeof(T) bytes) and
// does 16 rows of work per weight byte, far below the ~295 flop/byte ridge.
// Prefill (M = 512..1024) is closer to the ridge; in f32 the FFMA peak
// (67 TFLOP/s) is the operations bound.  This first version is simple and
// right: synchronous loads, no cp.async/TMA pipeline and no wgmma; its time
// against the bound is recorded in PERF.md.
#include "common.cuh"
#include "tile_mma.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(tile::kThreads)
block_sparse_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const int* __restrict__ idx, const int* __restrict__ cnt,
                        T* __restrict__ y, int K, int N, int width, int bm,
                        int bn, int bk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int xld = tile::kSlab + tile::pad<T>(), wld = bn + tile::pad<T>();
  T* xs = reinterpret_cast<T*>(smem);  // bm x xld
  T* ws = xs + bm * xld;               // kSlab x wld
  float* scratch = reinterpret_cast<float*>(ws + tile::kSlab * wld);

  const int j = blockIdx.x;
  const int m0 = blockIdx.y * bm;
  const int slab = (bk % tile::kSlab == 0) ? tile::kSlab : 16;
  const int count = cnt[j];

  tile::Acc<T> acc;
  acc.zero();
  for (int s = 0; s < count; ++s) {
    const int k0 = idx[j * width + s] * bk;
    for (int kc = 0; kc < bk; kc += slab) {
      __syncthreads();  // the previous slab is consumed
      tile::stage_rows(xs, xld, x + (size_t)m0 * K + k0 + kc, K, bm, slab);
      tile::stage_rows(ws, wld, w + (size_t)(k0 + kc) * N + j * bn, N, slab, bn);
      __syncthreads();
      acc.mma(xs, xld, ws, wld, bm, bn, slab);
    }
  }
  acc.store(scratch, bm, bn, [&](int r, int c, float v) {
    y[(size_t)(m0 + r) * N + j * bn + c] = tile::from_float<T>(v);
  });
}

template <typename T>
int launch(const void* x, const void* w, const void* idx, const void* cnt,
           void* y, int Mp, int K, int N, int width, int bm, int bn, int bk,
           void* stream) {
  const dim3 grid(N / bn, Mp / bm);
  const size_t smem = sizeof(T) * (bm * (tile::kSlab + tile::pad<T>()) +
                                   tile::kSlab * (bn + tile::pad<T>())) +
                      tile::epilogue_bytes<T>();
  block_sparse_fwd_kernel<T><<<grid, tile::kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int*>(idx), static_cast<const int*>(cnt),
      static_cast<T*>(y), K, N, width, bm, bn, bk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (Mp, K), w (K, N) row-major in the entry's element type; idx (N/bn,
// width), cnt (N/bn,) int32; y (Mp, N) like x.  The wrapper checks
// Mp % bm == 0, K % bk == 0, N % bn == 0, bm, bn, bk multiples of 16 up to
// 128, 16-byte alignment.
extern "C" int block_sparse_fwd_bf16(const void* x, const void* w, const void* idx,
                                     const void* cnt, void* y, int Mp, int K, int N,
                                     int width, int bm, int bn, int bk, void* stream) {
  return launch<__nv_bfloat16>(x, w, idx, cnt, y, Mp, K, N, width, bm, bn, bk, stream);
}

extern "C" int block_sparse_fwd_f32(const void* x, const void* w, const void* idx,
                                    const void* cnt, void* y, int Mp, int K, int N,
                                    int width, int bm, int bn, int bk, void* stream) {
  return launch<float>(x, w, idx, cnt, y, Mp, K, N, width, bm, bn, bk, stream);
}
