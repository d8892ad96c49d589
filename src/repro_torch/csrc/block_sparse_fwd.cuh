// The block-sparse forward kernel shared by K1 (block_sparse_fwd.cu, one
// weight matrix) and K4 (block_sparse_grouped.cu, a bank of G matrices),
// on the GEMM core (gemm_core.cuh).
//
// y[g] = x[g] @ W[g] over the active (bk, bn) blocks of W[g], for every group
// g of the bank (K1 is the bank of one).  W[g] is described by its CSC pack
// (core/pack.py): idx[g, j, :cnt[g, j]] lists the active K-blocks of N-block
// column j; every group's pack has the bank's one shared width, and slots
// past cnt[g, j] hold sentinel ids that are never read.
//
// Design.  One CTA per (column tile, row tile, group x split): grid dim x
// the column tiles, ceil(bn / BN) of them in each block column, so that a
// CTA tile never spans two block columns (each has its own list) and the
// column extent is the block column's own end j * bn + bn, where the copies
// zero-fill and the store clips.  The CTA reads cnt[g, j] on the device (no
// count is read on the host: the decode step runs inside a CUDA graph),
// stages its part of the list idx[g, j, :cnt] into shared memory once, and
// walks it with the core's packed slab map: A = x's rows (gemm::RowsA, row
// stride K), B = w's rows as they lie (gemm::DenseRowsB, row stride N),
// each slab a 32-row piece of one active block, its extent the block's end;
// there is no mask operand: the pack decides which blocks are read, so an
// inf or NaN in x or w outside the active blocks never reaches y.  The core
// runs a cp.async ring with register accumulators, bf16 on mma.sync
// m16n8k16, f32 as 3xTF32 on m16n8k8 with a per-slab f32 promotion, and a
// CTA whose f32 sums hold a NaN walks again with the exact split, so an inf
// in x inside an active block gives the plain version's +-inf.
//
// Split.  The host plan (kernels/block_sparse_matmul.py::fwd_plan, the
// core's split rule on the forward pack's live blocks) may split each
// column's walk of n = cnt[g, j] * spb slabs (spb = ceil(bk / 32)) in n_split parts:
// split s walks slabs [s n / n_split, (s + 1) n / n_split) and stores its
// f32 partial, zeros for an empty part, into part (n_split, G, Mp, N);
// the masked forward's merge (masked_merge_kernel, masked_matmul.cu), whose
// layout this is, sums them in split order and rounds once.
// No atomics: two launches give the same bits.
//
// Traps handled here:
//  * a column with cnt[g, j] == 0 still writes its (zero) tile: the
//    wrapper's output comes from torch.empty.  A dead expert (every count of
//    its group zero) is such a group: its whole output is zeros;
//  * decode has M = capacity rows (e.g. 4); the wrapper pads them to 16 and
//    slices the padded rows off; the 16 x 64 tile holds them;
//  * bk is any multiple of 16 up to 128 (it clamps to K in small layers):
//    a slab never crosses its block's end.
//
// Bound on the H100: decode (16 padded rows) is weight-bandwidth-bound: it
// must read every active block once (nnz * bk * bn * sizeof(T) bytes) at 16
// rows of work per weight byte, far below the ~295 flop/byte ridge; the
// split fills the card's slots with copies in flight.  Prefill and
// training (M = 512..2048) do 2 M bk bn flops an active block: bf16 near
// the ridge, f32 as three TF32 products each (495 TFLOP/s of TF32).  The
// times against the bound are in PERF.md.
#pragma once
#include "common.cuh"
#include "gemm_launch.cuh"

namespace {

// x (G, Mp, K), w (G, K, N), idx (G, N/bn, width), cnt (G, N/bn), y (G, Mp,
// N); C a configuration with A = x by RowsA and B = w by DenseRowsB;
// blockIdx = (column tile, row tile, group * n_split + split).  With
// n_split > 1 the split's f32 partial goes into part (n_split, G, Mp, N) in
// place of y.
template <class C>
__global__ void __launch_bounds__(C::kThreads, C::MIN_CTAS)
block_sparse_fwd_gemm_kernel(const typename C::Type* __restrict__ x,
                             const typename C::Type* __restrict__ w,
                             const int* __restrict__ idx, const int* __restrict__ cnt,
                             typename C::Type* __restrict__ y, float* __restrict__ part, int G,
                             int Mp, int K, int N, int width, int bk, int bn, int n_split) {
  using T = typename C::Type;
  extern __shared__ __align__(128) unsigned char smem[];
  int* ids = reinterpret_cast<int*>(smem + C::SMEM);
  const int per_col = (bn + C::BN - 1) / C::BN;  // column tiles a block column
  const int j = blockIdx.x / per_col;
  const int n0 = j * bn + (blockIdx.x % per_col) * C::BN, n1 = j * bn + bn;
  const int m0 = blockIdx.y * C::BM;
  const int grp = blockIdx.z / n_split, sp = blockIdx.z % n_split;
  const size_t col = (size_t)grp * (N / bn) + j;  // the group's block column
  const int spb = (bk + gemm::kSlab - 1) / gemm::kSlab;
  const int n = cnt[col] * spb;
  const int s0 = sp * n / n_split, s1 = (sp + 1) * n / n_split;
  // this split's blocks of the list, at their own positions
  for (int i = s0 / spb + threadIdx.x; i < (s1 + spb - 1) / spb; i += C::kThreads)
    ids[i] = idx[col * width + i];
  __syncthreads();
  const T* xg = x + (size_t)grp * Mp * K;
  const T* wg = w + (size_t)grp * K * N;
  const gemm::PackedMap map{ids, bk, spb, s0};
  gemm::Warp<C> warp;
  warp.zero();
  gemm::walk_map<C>(warp, xg, K, wg, N, nullptr, Mp, n1, map, m0, n0, s1 - s0, smem);
  if constexpr (sizeof(T) == 4) {
    // a NaN in f32's sums: an inf or NaN input; walk again with the exact
    // split, which keeps an inf operand's products inf (gemm_core.cuh)
    if (__syncthreads_or(warp.any_nan())) {
      warp.zero();
      gemm::walk_map<C, true>(warp, xg, K, wg, N, nullptr, Mp, n1, map, m0, n0, s1 - s0, smem);
    }
  }
  if (n_split == 1) {
    T* yg = y + (size_t)grp * Mp * N;
    gemm::store(warp, Mp, n1, m0, n0, [&](int r, int c, float v0, float v1) {
      gemm::store2(yg + (size_t)r * N + c, v0, v1);
    });
  } else {
    float* pg = part + ((size_t)sp * G + grp) * Mp * N;
    gemm::store(warp, Mp, n1, m0, n0, [&](int r, int c, float v0, float v1) {
      gemm::store2(pg + (size_t)r * N + c, v0, v1);
    });
  }
}

// x (G, Mp, K), w (G, K, N) row-major in the element type; idx (G, N/bn,
// width), cnt (G, N/bn) int32; y (G, Mp, N) like x.  The wrappers check K %
// bk == 0, N % bn == 0, bk and bn multiples of 16 up to 128, 16-byte
// alignment.  (tm, tn) a built tile; with n_split > 1, part is the f32
// workspace (n_split, G, Mp, N) and the masked forward's merge
// (masked_matmul.cu's masked_merge_<S>) must follow.
template <typename T>
int launch_block_sparse_fwd(const void* x, const void* w, const void* idx, const void* cnt,
                            void* y, void* part, int G, int Mp, int K, int N, int width,
                            int bk, int bn, int tm, int tn, int n_split, void* stream) {
  return gemm::with_tile<T, gemm::DenseRowsB>(tm, tn, [&](auto tag) {
    using C = typename decltype(tag)::type;
    const auto kernel = block_sparse_fwd_gemm_kernel<C>;
    const int smem = gemm::packed_smem_bytes<C>(width);
    cudaError_t err = gemm::prepare(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((N / bn) * ((bn + C::BN - 1) / C::BN), (Mp + C::BM - 1) / C::BM,
                    G * n_split);
    kernel<<<grid, C::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const int*>(idx),
        static_cast<const int*>(cnt), static_cast<T*>(y), static_cast<float*>(part), G, Mp,
        K, N, width, bk, bn, n_split);
    return static_cast<int>(cudaGetLastError());
  });
}

// out: gemm::launch_info of the forward kernel on the tile (tm, tn) with a
// list of ``width`` ids.
template <typename T>
int block_sparse_fwd_info(int tm, int tn, int width, int* out) {
  return gemm::with_tile<T, gemm::DenseRowsB>(tm, tn, [&](auto tag) {
    using C = typename decltype(tag)::type;
    return gemm::launch_info(block_sparse_fwd_gemm_kernel<C>, gemm::packed_smem_bytes<C>(width),
                             C::kThreads, out);
  });
}

}  // namespace
