// The block-sparse backward kernels shared by K2/K3/K7 (block_sparse_bwd.cu,
// one weight matrix) and K5/K6/K8 (block_sparse_grouped.cu, a bank of G
// matrices): the dgrad dx[g] = g[g] @ W[g]^T over a CSR pack, the packed
// wgrad dw[g] = x[g]^T @ g[g] on the active blocks of a CSC pack, and the
// same wgrad with the fused SGD epilogue (K7/K8): each active block stores
// the new momentum mu * mom + x^T g + wd * w (epilogue.cuh), optionally
// stochastically rounded to the bf16 grid, for every group g of the bank
// (K2/K3/K7 are the bank of one).  The grid's third dimension is the
// group (times the dgrad's and the wgrad's split), as K4 runs K1's kernel
// (block_sparse_fwd.cuh, on the GEMM core with the packed walk).
//
// Packs (core/pack.py), stacked over the groups at one shared width each:
// the CSR ridx[g, k, :rcnt[g, k]] lists the active N-blocks of K-block row
// k, the CSC idx[g, j, :cnt[g, j]] the active K-blocks of N-block column j
// (the Top-KAST superset bidx/bcnt on the training path).  The reference
// stores the wgrad blocks packed and scatters them into a zero (K, N) array
// in jnp (_scatter_packed_dw); here each block is written straight into the
// zeroed dense dw (the wrapper allocates it with torch.zeros), which is the
// same function: every live block is written once and padded slots write
// nothing, so dw is +0.0 off the pack whatever x and g hold.
//
// Design (no atomics; every sum in a fixed order, so results repeat run to
// run): the TPU kernels carry their accumulators across a sequential grid
// axis; here a loop inside one CTA takes its place, and the dgrad and the
// wgrad may split it into parts that a second kernel sums in order.
//  * dgrad (K2/K5), on the GEMM core (gemm_core.cuh) with the packed slab
//    map, as the block-sparse forward K1/K4 walks its CSC lists: one CTA per
//    (row tile, column tile of dx, group x split), ceil(bk / BN) column
//    tiles in each K-block row kb, so that a tile never spans two block
//    rows (each has its own list) and the column extent is the row's own
//    end kb * bk + bk, where the copies zero-fill and the store clips.  The
//    CTA reads rcnt[g, kb] on the device (no count is read on the host: the
//    training step does not sync), stages its split's part of the list
//    ridx[g, kb, :rcnt] into shared memory after the ring, and walks it:
//    A = g's rows (gemm::RowsA, row stride N), B = w's rows of the column
//    tile as they lie in w (gemm::DenseColsB, row stride N: n-major, read
//    by ldmatrix without a transpose), each slab a 32-column piece of one
//    active N-block, its extent the block's end (bn, any multiple of 16 up
//    to 128).  Nothing reads an inactive block, so an inf or NaN in g or w
//    outside the active blocks never reaches dx; f32 runs as 3xTF32 with
//    the exact re-walk of a tile whose sums hold a NaN, so an inf in g
//    inside an active block gives the plain version's +-inf.  A row with
//    rcnt = 0 still stores its zero tile (dx comes from torch.empty), so a
//    dead expert's dx is zeros.  The grid walks the row tiles fastest
//    (DenseColsB), so the CTAs that read one block row of w run side by
//    side.  The host plan (kernels/block_sparse_matmul.py::dx_plan, the
//    core's split rule on the forward pack's live blocks) may split each
//    row's walk of n = rcnt * ceil(bn / 32) slabs in n_split parts: split
//    s walks slabs [s n / n_split, (s + 1) n / n_split) and stores its f32
//    partial, zeros for an empty part, into part (n_split, G, Mp, K); the
//    masked forward's merge (masked_merge_kernel, masked_matmul.cu), whose
//    layout this is, sums them in split order and rounds once.
//  * wgrad (K3/K6), on the GEMM core (gemm_core.cuh, as the masked wgrad
//    K15/K18): one CTA per packed slot (s, j, g), grid dim x the slot so
//    that the CTAs of one block column, which read the same g columns, run
//    side by side.  The CTA owns the dw tile of its block, k0 = idx[g, j,
//    s] * bk, n0 = j * bn, and walks the M rows in a cp.async ring of
//    32-row slabs: A = x^T staged as x lies (gemm::ColsA, x's row stride K),
//    B = g's slab (gemm::DenseRowsB, row stride N); mma.sync with
//    register accumulators, bf16 on m16n8k16, f32 as 3xTF32 with the exact
//    re-walk of a tile whose sums hold a NaN (an inf in x or g gives the
//    plain version's +-inf).  A block smaller than the CTA tile (bk, bn
//    multiples of 16 up to 128) runs in the smallest built tile that holds
//    it (128 x 64 for bn <= 64, else 128 x 128): the block's edges k0 + bk
//    and n0 + bn are the extents the copies zero-fill past and the store
//    clips at, apart from the row strides.  No mask at the store: the block
//    is live by construction.  Slots s >= cnt[g, j] return before any copy:
//    a dead expert's dw stays zero and no empty sum is taken.  The host plan
//    (kernels/block_sparse_matmul.py::dw_plan, on the live CTAs)
//    may split the M walk in n_split parts: each stores its f32 partial in
//    the reference's packed layout (n_split, G, N/bn, width, bk, bn), padded
//    slots writing nothing, and block_sparse_dw_merge_kernel sums each live
//    slot's parts in order, rounds once and writes the block into dw: the
//    merge moves the live blocks only.
//  * fused wgrad (K7/K8): K3/K6's kernel with another epilogue policy
//    (epilogue.cuh's Momentum without a mask, the policy K19/K20 take with
//    theirs), not a second walk.  After the walk (and the exact re-walk) an
//    unsplit CTA stages its block's w and mom tiles into the ring's free
//    shared memory by cp.async where both fit (else the fold reads them
//    from global memory), folds mu * mom + acc + wd * w into its sums in
//    epi::momentum's order, and stores m_new in the output type (w's on
//    the training path, f32 for a check before the rounding), with sr
//    rounded onto the bf16 grid on the element's id (g * K + row) * N +
//    col in wrapping uint32, as the reference's.  A split stores the same
//    unfused f32 partials as K3's, and block_sparse_dw_fused_merge_kernel
//    (K3's merge with the Momentum policy) sums each live slot's parts in
//    order, then folds the momentum, applies sr and rounds once.  The reference wrote every
//    slot of a packed array, zeroed the padded ones before sr and scattered
//    them with .add into a zero (K, N); here a padded slot returns before
//    any copy into the zero-filled dense output, which is the same
//    function.  A group with no active block writes nothing (exact zeros);
//    a dead expert whose blocks are active but which got no rows stores mu
//    * mom + wd * w there.
// Each CTA loops to its own group's count, never to the shared width, so a
// lopsided expert that widens the pack costs the others nothing but the
// early return of their padded wgrad slots.  Each output is rounded once to
// the element type (dx: g's, dw: w's, which the wrappers hand in alike;
// m_new: the output type).
//
// Bound on the H100: at the training shapes (M = 2048 rows, or an MoE
// bank's capacity of ~176 rows per expert, 128x128 blocks) each does 2 * M
// * 128 * 128 flops per active block and moves the active weight/gradient
// blocks plus x and g once: below the ~295 flop/byte ridge in bf16, so
// bytes bound them there; in f32 the FFMA peak (67 TFLOP/s, the bound
// chip_smoke.py states) bounds them at M = 2048, bytes at an expert's few
// hundred rows (the GEMM core's f32 runs as 3xTF32 on the tensor cores,
// 495 TFLOP/s of TF32 for three products a multiply-add).  K7/K8 add the
// reads of the superset blocks' w and mom tiles (and write m_new there
// instead of dw): a few percent more bytes, the same flops.  The times
// against the bound are in PERF.md.
#pragma once
#include "common.cuh"
#include "epilogue.cuh"
#include "gemm_launch.cuh"

namespace {

// K2/K5 on the GEMM core.  g (G, Mp, N), w (G, K, N), ridx (G, K/bk,
// width), rcnt (G, K/bk), dx (G, Mp, K); C a configuration with A = g by
// RowsA and B = w by DenseColsB; blockIdx = (row tile, column tile, group *
// n_split + split), x and y swapped where C::StageB walks the column tiles
// fastest.  With n_split > 1 the split's f32 partial goes into part
// (n_split, G, Mp, K) in place of dx.
template <class C>
__global__ void __launch_bounds__(C::kThreads, C::MIN_CTAS)
block_sparse_dx_gemm_kernel(const typename C::Type* __restrict__ g,
                            const typename C::Type* __restrict__ w,
                            const int* __restrict__ ridx, const int* __restrict__ rcnt,
                            typename C::Type* __restrict__ dx, float* __restrict__ part, int G,
                            int Mp, int K, int N, int width, int bk, int bn, int n_split) {
  using T = typename C::Type;
  constexpr bool kRowsFastest = C::StageB::kRowTilesFastest;
  extern __shared__ __align__(128) unsigned char smem[];
  int* ids = reinterpret_cast<int*>(smem + C::SMEM);
  const int per_row = (bk + C::BN - 1) / C::BN;  // column tiles a block row
  const int ct = kRowsFastest ? blockIdx.y : blockIdx.x;
  const int kb = ct / per_row;
  const int n0 = kb * bk + (ct % per_row) * C::BN, n1 = kb * bk + bk;
  const int m0 = (kRowsFastest ? blockIdx.x : blockIdx.y) * C::BM;
  const int grp = blockIdx.z / n_split, sp = blockIdx.z % n_split;
  const size_t row = (size_t)grp * (K / bk) + kb;  // the group's block row
  const int spb = (bn + gemm::kSlab - 1) / gemm::kSlab;
  const int n = rcnt[row] * spb;
  const int s0 = sp * n / n_split, s1 = (sp + 1) * n / n_split;
  // this split's blocks of the list, at their own positions
  for (int i = s0 / spb + threadIdx.x; i < (s1 + spb - 1) / spb; i += C::kThreads)
    ids[i] = ridx[row * width + i];
  __syncthreads();
  const T* gg = g + (size_t)grp * Mp * N;
  const T* wg = w + (size_t)grp * K * N;
  const gemm::PackedMap map{ids, bn, spb, s0};
  gemm::Warp<C> warp;
  warp.zero();
  gemm::walk_map<C>(warp, gg, N, wg, N, nullptr, Mp, n1, map, m0, n0, s1 - s0, smem);
  if constexpr (sizeof(T) == 4) {
    // a NaN in f32's sums: an inf or NaN input; walk again with the exact
    // split, which keeps an inf operand's products inf (gemm_core.cuh)
    if (__syncthreads_or(warp.any_nan())) {
      warp.zero();
      gemm::walk_map<C, true>(warp, gg, N, wg, N, nullptr, Mp, n1, map, m0, n0, s1 - s0, smem);
    }
  }
  if (n_split == 1) {
    T* o = dx + (size_t)grp * Mp * K;
    gemm::store(warp, Mp, n1, m0, n0, [&](int r, int c, float v0, float v1) {
      gemm::store2(o + (size_t)r * K + c, v0, v1);
    });
  } else {
    float* p = part + ((size_t)sp * G + grp) * Mp * K;
    gemm::store(warp, Mp, n1, m0, n0, [&](int r, int c, float v0, float v1) {
      gemm::store2(p + (size_t)r * K + c, v0, v1);
    });
  }
}

// K3/K6 (Epi = epi::Out) and K7/K8 (Epi = epi::Momentum without a mask) on
// the GEMM core.  x (G, Mp, K), g (G, Mp, N), idx (G, N/bn, width), cnt
// (G, N/bn); the output (G, K, N), zero-filled by the caller, written by
// Epi on the live blocks; C a wgrad configuration (A = x^T by ColsA, B = g
// by DenseRowsB) whose tile holds a (bk, bn) block; blockIdx = (slot s,
// block column j, group * n_split + split).  Split sp walks the slabs [sp
// n / n_split, (sp + 1) n / n_split) of the n = ceil(Mp / 32) and, when
// n_split > 1, stores its f32 partial (the sum alone, whatever Epi) into
// the packed part (n_split, G, N/bn, width, bk, bn) in place of Epi's
// store.
template <class C, class Epi>
__global__ void __launch_bounds__(C::kThreads, C::MIN_CTAS)
block_sparse_dw_gemm_kernel(const typename C::Type* __restrict__ x,
                            const typename C::Type* __restrict__ g,
                            const int* __restrict__ idx, const int* __restrict__ cnt,
                            const Epi epi, float* __restrict__ part, int G, int Mp, int K,
                            int N, int width, int bk, int bn, int n_split) {
  using T = typename C::Type;
  const int s = blockIdx.x, j = blockIdx.y;
  const int grp = blockIdx.z / n_split, sp = blockIdx.z % n_split;
  const size_t col = (size_t)grp * (N / bn) + j;  // the group's block column
  if (s >= cnt[col]) return;  // a padded slot: the output stays zero there, part unwritten
  extern __shared__ __align__(128) unsigned char smem[];
  const int k0 = idx[col * width + s] * bk, n0 = j * bn;
  const T* xg = x + (size_t)grp * Mp * K;
  const T* gg = g + (size_t)grp * Mp * N;
  const int n_slabs = (Mp + gemm::kSlab - 1) / gemm::kSlab;
  const int s0 = sp * n_slabs / n_split, s1 = (sp + 1) * n_slabs / n_split;
  // A = x^T: x's columns k0.. (row stride K), B: g's columns n0.. (row
  // stride N); the block's own edges k0 + bk and n0 + bn are the extents
  // the copies zero-fill past and the store clips at
  gemm::Warp<C> warp;
  warp.zero();
  gemm::walk<C>(warp, xg, K, gg, N, nullptr, k0 + bk, n0 + bn, Mp, k0, n0, s0, s1, smem);
  if constexpr (sizeof(T) == 4) {
    // a NaN in f32's sums: an inf or NaN input; walk again with the exact
    // split, which keeps an inf operand's products inf (gemm_core.cuh)
    if (__syncthreads_or(warp.any_nan())) {
      warp.zero();
      gemm::walk<C, true>(warp, xg, K, gg, N, nullptr, k0 + bk, n0 + bn, Mp, k0, n0, s0, s1,
                          smem);
    }
  }
  if (n_split == 1) {
    const size_t plane0 = (size_t)grp * K * N;
    epi.template fold<C>(warp, plane0, N, k0 + bk, n0 + bn, k0, n0, smem);
    gemm::store(warp, k0 + bk, n0 + bn, k0, n0, [&](int r, int c, float v0, float v1) {
      epi.pair(plane0 + (size_t)r * N + c, v0, v1, 0u);
    });
  } else {
    float* p = part + (((size_t)sp * G * (N / bn) + col) * width + s) * bk * bn;
    gemm::store(warp, k0 + bk, n0 + bn, k0, n0, [&](int r, int c, float v0, float v1) {
      gemm::store2(p + (r - k0) * bn + c - n0, v0, v1);
    });
  }
}

// The split merge of K3/K6 and K7/K8: for every live slot (s, j, group),
// the sum over sp of part[sp] at the slot (sp = 0, 1, ... in order), then
// Epi's store into the block's place in the output: rounded once (K3/K6),
// or the momentum folded, sr, rounded once (K7/K8).  Padded slots are
// neither read nor written; the merge moves the live blocks only.  A
// block's float4s are spread over kMergeChunks CTAs (blockIdx.z = group *
// kMergeChunks + chunk) and each thread's loads are unrolled: one CTA a
// block kept too few loads in flight (a 70-block merge took 19 µs for 12
// MB on an H100, PERF.md).
constexpr int kMergeChunks = 4;

template <class Epi>
__device__ __forceinline__ void merge_blocks(const float* __restrict__ part,
                                             const int* __restrict__ idx,
                                             const int* __restrict__ cnt, const Epi& epi, int G,
                                             int K, int N, int width, int bk, int bn,
                                             int n_split) {
  const int s = blockIdx.x, grp = blockIdx.z / kMergeChunks;
  const size_t col = (size_t)grp * (N / bn) + blockIdx.y;
  if (s >= cnt[col]) return;
  const int k0 = idx[col * width + s] * bk, n0 = blockIdx.y * bn;
  const size_t area = (size_t)bk * bn, plane4 = (size_t)G * (N / bn) * width * area / 4;
  const float4* p = reinterpret_cast<const float4*>(part + (col * width + s) * area);
  const size_t o = ((size_t)grp * K + k0) * N + n0;  // the block's first element
  const int n4 = bk * bn / 4, per = (n4 + kMergeChunks - 1) / kMergeChunks;
  const int i0 = (blockIdx.z % kMergeChunks) * per, i1 = min(n4, i0 + per);
#pragma unroll 4
  for (int i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
    float4 v = p[i];
    for (int sp = 1; sp < n_split; ++sp) {
      const float4 q = p[i + sp * plane4];
      v.x += q.x;
      v.y += q.y;
      v.z += q.z;
      v.w += q.w;
    }
    epi.quad(o + (size_t)(4 * i / bn) * N + 4 * i % bn, v);
  }
}

// K3/K6's merge keeps ptxas's own register count (40 on an H100): held to
// 64 its 4-split merge at 286 f32 blocks took 45 µs against 43, and with a
// minimum of one CTA an SM it took 118 registers and 52 µs (PERF.md).
template <class Epi>
__global__ void __launch_bounds__(256)
block_sparse_dw_merge_kernel(const float* __restrict__ part, const int* __restrict__ idx,
                             const int* __restrict__ cnt, const Epi epi, int G, int K, int N,
                             int width, int bk, int bn, int n_split) {
  merge_blocks(part, idx, cnt, epi, G, K, N, width, bk, bn, n_split);
}

// K7/K8's holds at most 64 registers a thread (4 CTAs an SM), as the
// masked merges: ptxas had held a momentum merge of a bf16 w to 32 and
// spilled.
template <class Epi>
__global__ void __launch_bounds__(256, 4)
block_sparse_dw_fused_merge_kernel(const float* __restrict__ part, const int* __restrict__ idx,
                                   const int* __restrict__ cnt, const Epi epi, int G, int K,
                                   int N, int width, int bk, int bn, int n_split) {
  merge_blocks(part, idx, cnt, epi, G, K, N, width, bk, bn, n_split);
}

// g (G, Mp, N), w (G, K, N) row-major in the element type; ridx (G, K/bk,
// width), rcnt (G, K/bk) int32; dx (G, Mp, K) like g.  The wrappers check
// K % bk == 0, N % bn == 0, bk and bn multiples of 16 up to 128, 16-byte
// alignment.  (tm, tn) a built tile; with n_split > 1, part is the f32
// workspace (n_split, G, Mp, K) and the masked forward's merge
// (masked_matmul.cu's masked_merge_<S>) must follow.
template <typename T>
int launch_block_sparse_dx(const void* g, const void* w, const void* ridx, const void* rcnt,
                           void* dx, void* part, int G, int Mp, int K, int N, int width,
                           int bk, int bn, int tm, int tn, int n_split, void* stream) {
  return gemm::with_tile<T, gemm::DenseColsB>(tm, tn, [&](auto tag) {
    using C = typename decltype(tag)::type;
    const auto kernel = block_sparse_dx_gemm_kernel<C>;
    const int smem = gemm::packed_smem_bytes<C>(width);
    cudaError_t err = gemm::prepare(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned row_tiles = (Mp + C::BM - 1) / C::BM;
    const unsigned col_tiles = (K / bk) * ((bk + C::BN - 1) / C::BN);
    const bool rows_fastest = C::StageB::kRowTilesFastest;
    const dim3 grid(rows_fastest ? row_tiles : col_tiles, rows_fastest ? col_tiles : row_tiles,
                    G * n_split);
    kernel<<<grid, C::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(g), static_cast<const T*>(w), static_cast<const int*>(ridx),
        static_cast<const int*>(rcnt), static_cast<T*>(dx), static_cast<float*>(part), G, Mp,
        K, N, width, bk, bn, n_split);
    return static_cast<int>(cudaGetLastError());
  });
}

// out: gemm::launch_info of the dgrad kernel on the tile (tm, tn) with a
// list of ``width`` ids.
template <typename T>
int block_sparse_dx_info(int tm, int tn, int width, int* out) {
  return gemm::with_tile<T, gemm::DenseColsB>(tm, tn, [&](auto tag) {
    using C = typename decltype(tag)::type;
    return gemm::launch_info(block_sparse_dx_gemm_kernel<C>, gemm::packed_smem_bytes<C>(width),
                             C::kThreads, out);
  });
}

// K3/K6 (Epi = epi::Out<T>) and K7/K8 (Epi = epi::Momentum<T, TM, TO,
// false>): the wgrad kernel on the tile (tm, tn) (a built wgrad tile that
// holds the block: bk <= tm, bn <= tn), split in n_split; with n_split >
// 1 part is the workspace (n_split, G, N/bn, width, bk, bn) f32 and
// launch_block_sparse_dw_merge with the same policy must follow.  The
// wrappers check Mp % 16 == 0, K % bk == 0, N % bn == 0, bk and bn
// multiples of 16 up to 128, 16-byte alignment.
template <typename T, class Epi>
int launch_block_sparse_dw(const void* x, const void* g, const void* idx, const void* cnt,
                           const Epi& epi, void* part, int G, int Mp, int K, int N, int width,
                           int bk, int bn, int tm, int tn, int n_split, void* stream) {
  if (bk > tm || bn > tn) return static_cast<int>(cudaErrorInvalidValue);
  return gemm::with_tile<T, gemm::DenseRowsB, gemm::ColsA>(tm, tn, [&](auto tag) {
    using C = typename decltype(tag)::type;
    const auto kernel = block_sparse_dw_gemm_kernel<C, Epi>;
    cudaError_t err = gemm::prepare(kernel, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(width, N / bn, G * n_split);
    kernel<<<grid, C::kThreads, C::SMEM, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const int*>(idx),
        static_cast<const int*>(cnt), epi, static_cast<float*>(part), G, Mp, K, N, width, bk,
        bn, n_split);
    return static_cast<int>(cudaGetLastError());
  });
}

// kernel: block_sparse_dw_merge_kernel<Epi> (K3/K6) or
// block_sparse_dw_fused_merge_kernel<Epi> (K7/K8).
template <class Kernel, class Epi>
int launch_block_sparse_dw_merge(Kernel kernel, const void* part, const void* idx,
                                 const void* cnt, const Epi& epi, int G, int K, int N, int width,
                                 int bk, int bn, int n_split, void* stream) {
  const dim3 grid(width, N / bn, G * kMergeChunks);
  kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<const int*>(idx),
      static_cast<const int*>(cnt), epi, G, K, N, width, bk, bn, n_split);
  return static_cast<int>(cudaGetLastError());
}

// out: gemm::launch_info of the wgrad kernel with the policy Epi on the
// tile (tm, tn).
template <typename T, class Epi>
int block_sparse_dw_info(int tm, int tn, int* out) {
  return gemm::with_tile<T, gemm::DenseRowsB, gemm::ColsA>(tm, tn, [&](auto tag) {
    using C = typename decltype(tag)::type;
    return gemm::launch_info(block_sparse_dw_gemm_kernel<C, Epi>, C::SMEM, C::kThreads, out);
  });
}

}  // namespace
