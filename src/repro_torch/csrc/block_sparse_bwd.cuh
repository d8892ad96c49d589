// The block-sparse backward kernels shared by K2/K3/K7 (block_sparse_bwd.cu,
// one weight matrix) and K5/K6/K8 (block_sparse_grouped.cu, a bank of G
// matrices): the dgrad dx[g] = g[g] @ W[g]^T over a CSR pack, the packed
// wgrad dw[g] = x[g]^T @ g[g] on the active blocks of a CSC pack, and the
// same wgrad with the fused SGD epilogue (K7/K8): each active block stores
// the new momentum mu * mom + x^T g + wd * w (epilogue.cuh), optionally
// stochastically rounded to the bf16 grid, for every group g of the bank
// (K2/K3/K7 are the bank of one).  The grid's third dimension is the
// group, as K4 runs K1's kernel (block_sparse_fwd.cuh).
//
// Packs (core/pack.py), stacked over the groups at one shared width each:
// the CSR ridx[g, k, :rcnt[g, k]] lists the active N-blocks of K-block row
// k, the CSC idx[g, j, :cnt[g, j]] the active K-blocks of N-block column j
// (the Top-KAST superset bidx/bcnt on the training path).  The reference
// stores the wgrad blocks packed and scatters them into a zero (K, N) array
// in jnp (_scatter_packed_dw); here each block is written straight into the
// zeroed dense dw (the wrapper allocates it with torch.zeros), which is the
// same function: every live block is written once and padded slots write
// nothing.
//
// Design (no atomics; every sum in a fixed order, so results repeat run to
// run): the TPU kernels carry their accumulators across a sequential grid
// axis; here a loop inside one CTA takes its place.
//  * dgrad: one CTA of 8 warps per (K-block row k, m-tile of bm rows, group
//    g), walking ridx[g, k, :rcnt[g, k]]; A = the g tile (bm x slab), B =
//    the slab of W^T (slab x bk, staged transposed).  A row with rcnt = 0
//    still writes its zero dx tile (dx comes from torch.empty), so a dead
//    expert's dx rows are zeros.
//  * wgrad: one CTA per (j, s, g) slot, looping over the M rows in slabs of
//    32; A = x^T (bk x slab, staged transposed), B = the g slab (slab x bn).
//    Slots s >= cnt[g, j] return at once: a dead expert's dw stays zero and
//    no empty sum is taken.
//  * fused wgrad (K7/K8): the wgrad's CTA, whose store reads the block's w
//    and mom tiles and writes m_new in the output type (w's on the
//    training path, f32 for a check before the rounding).  The reference
//    wrote every slot of a packed array, zeroed the padded ones before sr
//    and scattered them with .add into a zero (K, N); here a padded slot
//    returns before any store into the zero-filled dense output, which is
//    the same function.  The sr id is the element's (g * K + row) * N +
//    col in wrapping uint32, as the reference's.  A group with no active
//    block writes nothing (exact zeros); a dead expert whose blocks are
//    active but which got no rows stores mu * mom + wd * w there.
// Each CTA loops to its own group's count, never to the shared width, so a
// lopsided expert that widens the pack costs the others nothing but the
// early return of their padded wgrad slots.
// Products accumulate in f32 (tile_mma.cuh): bf16 on the tensor cores
// (wmma), f32 in full-precision FFMA (the reference's f32 MLP and MoE
// banks); each output is rounded once to the element type (dx: x's, dw:
// w's, which the wrappers hand in alike).
//
// Bound on the H100: at the training shapes (M = 2048 rows, or an MoE
// bank's capacity of ~176 rows per expert, 128x128 blocks) both do 2 * M *
// 128 * 128 flops per active block and move the active weight/gradient
// blocks plus x and g once: below the ~295 flop/byte ridge in bf16, so
// bytes bound them there; in f32 the FFMA peak (67 TFLOP/s) bounds them at
// M = 2048, bytes at an expert's few hundred rows.  K7/K8 add the reads of
// the superset blocks' w and mom tiles (and write m_new there instead of
// dw): a few percent more bytes, the same flops.  This first version uses
// synchronous loads and wmma/FFMA (no cp.async/TMA, no wgmma); its times
// against the bound are in PERF.md.
#pragma once
#include "common.cuh"
#include "epilogue.cuh"

namespace {

// g (G, Mp, N), w (G, K, N), ridx (G, K/bk, row_width), rcnt (G, K/bk),
// dx (G, Mp, K).
template <typename T>
__global__ void __launch_bounds__(tile::kThreads)
block_sparse_dx_kernel(const T* __restrict__ g, const T* __restrict__ w,
                       const int* __restrict__ ridx, const int* __restrict__ rcnt,
                       T* __restrict__ dx, int Mp, int K, int N, int row_width,
                       int bm, int bn, int bk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int gld = tile::kSlab + tile::pad<T>(), wld = bk + tile::pad<T>();
  T* gs = reinterpret_cast<T*>(smem);  // bm x gld
  T* ws = gs + bm * gld;               // kSlab x wld: W^T slab
  float* scratch = reinterpret_cast<float*>(ws + tile::kSlab * wld);

  const int kb = blockIdx.x;
  const int m0 = blockIdx.y * bm;
  const size_t grp = blockIdx.z, nkb = K / bk;
  const T* gg = g + grp * Mp * N;
  const T* wg = w + grp * K * N;
  const int* rg = ridx + (grp * nkb + kb) * row_width;
  T* dxg = dx + grp * Mp * K;
  const int slab = (bn % tile::kSlab == 0) ? tile::kSlab : 16;
  const int count = rcnt[grp * nkb + kb];

  tile::Acc<T> acc;
  acc.zero();
  for (int s = 0; s < count; ++s) {
    const int n0 = rg[s] * bn;
    for (int nc = 0; nc < bn; nc += slab) {
      __syncthreads();
      tile::stage_rows(gs, gld, gg + (size_t)m0 * N + n0 + nc, N, bm, slab);
      // ws[l][c] = w[kb*bk + c][n0 + nc + l]
      tile::stage_cols(ws, wld, wg + (size_t)kb * bk * N + n0 + nc, N, bk, slab);
      __syncthreads();
      acc.mma(gs, gld, ws, wld, bm, bk, slab);
    }
  }
  acc.store(scratch, bm, bk, [&](int r, int c, float v) {
    dxg[(size_t)(m0 + r) * K + kb * bk + c] = tile::from_float<T>(v);
  });
}

// x (G, Mp, K), g (G, Mp, N), idx (G, N/bn, width), cnt (G, N/bn), dw (G,
// K, N) zero-filled by the caller.
template <typename T>
__global__ void __launch_bounds__(tile::kThreads)
block_sparse_dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       const int* __restrict__ idx, const int* __restrict__ cnt,
                       T* __restrict__ dw, int Mp, int K, int N, int width,
                       int bn, int bk) {
  const int j = blockIdx.x, s = blockIdx.y;
  const size_t grp = blockIdx.z, nnb = N / bn;
  if (s >= cnt[grp * nnb + j]) return;  // padded slot: dw stays zero there
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);               // bk x (kSlab + pad): x^T slab
  T* gs = xs + bk * (tile::kSlab + tile::pad<T>());  // kSlab x (bn + pad)
  float* scratch = reinterpret_cast<float*>(gs + tile::kSlab * (bn + tile::pad<T>()));

  T* dwg = dw + grp * K * N;
  const int k0 = idx[(grp * nnb + j) * width + s] * bk;
  const int n0 = j * bn;

  tile::Acc<T> acc;
  tile::xtg(acc, xs, gs, x + grp * Mp * K, g + grp * Mp * N, Mp, K, N, k0, n0, bn, bk);
  acc.store(scratch, bk, bn, [&](int r, int c, float v) {
    dwg[(size_t)(k0 + r) * N + n0 + c] = tile::from_float<T>(v);
  });
}

// K7/K8: x, g and w in T, mom in TM, the new momentum in TO; out (G, K, N)
// zero-filled by the caller.
template <typename T, typename TM, typename TO>
__global__ void __launch_bounds__(tile::kThreads)
block_sparse_dw_fused_kernel(const T* __restrict__ x, const T* __restrict__ g,
                             const int* __restrict__ idx, const int* __restrict__ cnt,
                             const T* __restrict__ w, const TM* __restrict__ mom,
                             TO* __restrict__ out, int Mp, int K, int N, int width,
                             int bn, int bk, unsigned seed, float mu, float wd, int sr) {
  const int j = blockIdx.x, s = blockIdx.y;
  const size_t grp = blockIdx.z, nnb = N / bn;
  if (s >= cnt[grp * nnb + j]) return;  // padded slot: out stays zero there
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);               // bk x (kSlab + pad): x^T slab
  T* gs = xs + bk * (tile::kSlab + tile::pad<T>());  // kSlab x (bn + pad)
  float* scratch = reinterpret_cast<float*>(gs + tile::kSlab * (bn + tile::pad<T>()));
  const size_t off = grp * K * N;
  const int k0 = idx[(grp * nnb + j) * width + s] * bk;
  const int n0 = j * bn;

  tile::Acc<T> acc;
  tile::xtg(acc, xs, gs, x + grp * Mp * K, g + grp * Mp * N, Mp, K, N, k0, n0, bn, bk);
  acc.store(scratch, bk, bn, [&](int r, int c, float v) {
    const size_t i = off + (size_t)(k0 + r) * N + n0 + c;
    float mn = epi::momentum(mu, mom[i], v, wd, w[i]);
    if (sr) mn = epi::sr_to_bf16(mn, seed, epi::element_id(grp, K, N, k0 + r, n0 + c));
    out[i] = tile::from_float<TO>(mn);
  });
}

template <typename T>
size_t bwd_smem_bytes(int rows, int cols) {
  return sizeof(T) * (rows * (tile::kSlab + tile::pad<T>()) +
                      tile::kSlab * (cols + tile::pad<T>())) +
         tile::epilogue_bytes<T>();
}

// The wrappers check Mp % bm == 0 (dgrad) or Mp % 16 == 0 (wgrad), K % bk
// == 0, N % bn == 0, bm, bn, bk multiples of 16 up to 128, 16-byte
// alignment.
template <typename T>
int launch_block_sparse_dx(const void* g, const void* w, const void* ridx,
                           const void* rcnt, void* dx, int G, int Mp, int K, int N,
                           int row_width, int bm, int bn, int bk, void* stream) {
  const dim3 grid(K / bk, Mp / bm, G);
  block_sparse_dx_kernel<T><<<grid, tile::kThreads, bwd_smem_bytes<T>(bm, bk),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<const T*>(w),
      static_cast<const int*>(ridx), static_cast<const int*>(rcnt),
      static_cast<T*>(dx), Mp, K, N, row_width, bm, bn, bk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_block_sparse_dw(const void* x, const void* g, const void* idx,
                           const void* cnt, void* dw, int G, int Mp, int K, int N,
                           int width, int bn, int bk, void* stream) {
  const dim3 grid(N / bn, width, G);
  block_sparse_dw_kernel<T><<<grid, tile::kThreads, bwd_smem_bytes<T>(bk, bn),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const int*>(idx), static_cast<const int*>(cnt),
      static_cast<T*>(dw), Mp, K, N, width, bn, bk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TM, typename TO>
int launch_block_sparse_dw_fused(const void* x, const void* g, const void* idx,
                                 const void* cnt, const void* w, const void* mom, void* out,
                                 int G, int Mp, int K, int N, int width, int bn, int bk,
                                 unsigned seed, float mu, float wd, int sr, void* stream) {
  const dim3 grid(N / bn, width, G);
  block_sparse_dw_fused_kernel<T, TM, TO>
      <<<grid, tile::kThreads, bwd_smem_bytes<T>(bk, bn),
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const int*>(idx),
          static_cast<const int*>(cnt), static_cast<const T*>(w),
          static_cast<const TM*>(mom), static_cast<TO*>(out), Mp, K, N, width, bn, bk,
          seed, mu, wd, sr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
