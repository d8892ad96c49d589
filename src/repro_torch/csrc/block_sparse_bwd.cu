// Block-sparse backward: dgrad (K2) and packed wgrad (K3) of y = x @ W.
//
// K2 replaces repro/kernels/block_sparse_matmul.py::_dx_kernel (pallas_call
// in _dx_call):  dx (M, K) = g (M, N) @ W^T over the active N-blocks of each
// K-block row, read from the CSR view ridx[k, :rcnt[k]] (core/pack.py).
// K3 replaces ::_dw_kernel (pallas_call in _dw_call):  for every active
// block (idx[j, s], j) of a CSC pack (the Top-KAST superset bidx/bcnt on the
// training path) dw[block] = x[:, k-block]^T @ g[:, j-block], summed over
// all M rows.  The reference stores the blocks packed and scatters them
// into a zero (K, N) array in jnp; here each block is written straight into
// the zeroed dense dw (the wrapper allocates it with torch.zeros), which is
// the same function: every live block is written once and padded slots
// write nothing.
//
// Design (no atomics; every sum in a fixed order, so results repeat run to
// run): the TPU kernels carry their accumulators across a sequential grid
// axis; here a loop inside one CTA takes its place.
//  * K2: one CTA of 8 warps per (K-block row k, m-tile of bm rows), walking
//    ridx[k, :rcnt[k]]; A = the g tile (bm x slab), B = the slab of W^T
//    (slab x bk, staged transposed).  A row with rcnt = 0 still writes its
//    zero dx tile (dx comes from torch.empty).
//  * K3: one CTA per (j, s) slot, looping over the M rows in slabs of 32;
//    A = x^T (bk x slab, staged transposed), B = the g slab (slab x bn).
//    Slots s >= cnt[j] return at once.
// Products accumulate in f32 (tile_mma.cuh): bf16 on the tensor cores (wmma),
// f32 in full-precision FFMA (the reference's f32 MLP); each output is
// rounded once to the element type (dx: x's, dw: w's).
//
// Bound on the H100: at the training shapes (M = 2048 rows, 128x128 blocks)
// K2 and K3 each do 2 * M * 128 * 128 flops per active block and move the
// active weight/gradient blocks plus x and g once, about 50-100 flops per
// byte in bf16: below the ~295 flop/byte ridge, so bytes bound them in bf16;
// in f32 the FFMA peak (67 TFLOP/s) bounds them.  This first version uses
// synchronous loads and wmma/FFMA (no cp.async/TMA, no wgmma); its times
// against the bound are in PERF.md.
#include "common.cuh"
#include "tile_mma.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(tile::kThreads)
block_sparse_dx_kernel(const T* __restrict__ g, const T* __restrict__ w,
                       const int* __restrict__ ridx, const int* __restrict__ rcnt,
                       T* __restrict__ dx, int K, int N, int row_width, int bm,
                       int bn, int bk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int gld = tile::kSlab + tile::pad<T>(), wld = bk + tile::pad<T>();
  T* gs = reinterpret_cast<T*>(smem);  // bm x gld
  T* ws = gs + bm * gld;               // kSlab x wld: W^T slab
  float* scratch = reinterpret_cast<float*>(ws + tile::kSlab * wld);

  const int kb = blockIdx.x;
  const int m0 = blockIdx.y * bm;
  const int slab = (bn % tile::kSlab == 0) ? tile::kSlab : 16;
  const int count = rcnt[kb];

  tile::Acc<T> acc;
  acc.zero();
  for (int s = 0; s < count; ++s) {
    const int n0 = ridx[kb * row_width + s] * bn;
    for (int nc = 0; nc < bn; nc += slab) {
      __syncthreads();
      tile::stage_rows(gs, gld, g + (size_t)m0 * N + n0 + nc, N, bm, slab);
      // ws[l][c] = w[kb*bk + c][n0 + nc + l]
      tile::stage_cols(ws, wld, w + (size_t)kb * bk * N + n0 + nc, N, bk, slab);
      __syncthreads();
      acc.mma(gs, gld, ws, wld, bm, bk, slab);
    }
  }
  acc.store(scratch, bm, bk, [&](int r, int c, float v) {
    dx[(size_t)(m0 + r) * K + kb * bk + c] = tile::from_float<T>(v);
  });
}

template <typename T>
__global__ void __launch_bounds__(tile::kThreads)
block_sparse_dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       const int* __restrict__ idx, const int* __restrict__ cnt,
                       T* __restrict__ dw, int Mp, int K, int N, int width,
                       int bn, int bk) {
  const int j = blockIdx.x, s = blockIdx.y;
  if (s >= cnt[j]) return;  // padded slot: dw stays zero there
  extern __shared__ __align__(128) unsigned char smem[];
  const int xld = tile::kSlab + tile::pad<T>(), gld = bn + tile::pad<T>();
  T* xs = reinterpret_cast<T*>(smem);  // bk x xld: x^T slab
  T* gs = xs + bk * xld;               // kSlab x gld
  float* scratch = reinterpret_cast<float*>(gs + tile::kSlab * gld);

  const int k0 = idx[j * width + s] * bk;
  const int n0 = j * bn;
  const int slab = (Mp % tile::kSlab == 0) ? tile::kSlab : 16;

  tile::Acc<T> acc;
  acc.zero();
  for (int m = 0; m < Mp; m += slab) {
    __syncthreads();
    // xs[r][l] = x[m + l][k0 + r]
    tile::stage_cols(xs, xld, x + (size_t)m * K + k0, K, slab, bk);
    tile::stage_rows(gs, gld, g + (size_t)m * N + n0, N, slab, bn);
    __syncthreads();
    acc.mma(xs, xld, gs, gld, bk, bn, slab);
  }
  acc.store(scratch, bk, bn, [&](int r, int c, float v) {
    dw[(size_t)(k0 + r) * N + n0 + c] = tile::from_float<T>(v);
  });
}

template <typename T>
size_t smem_bytes(int rows, int cols) {
  return sizeof(T) * (rows * (tile::kSlab + tile::pad<T>()) +
                      tile::kSlab * (cols + tile::pad<T>())) +
         tile::epilogue_bytes<T>();
}

template <typename T>
int launch_dx(const void* g, const void* w, const void* ridx, const void* rcnt,
              void* dx, int Mp, int K, int N, int row_width, int bm, int bn,
              int bk, void* stream) {
  const dim3 grid(K / bk, Mp / bm);
  block_sparse_dx_kernel<T><<<grid, tile::kThreads, smem_bytes<T>(bm, bk),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<const T*>(w),
      static_cast<const int*>(ridx), static_cast<const int*>(rcnt),
      static_cast<T*>(dx), K, N, row_width, bm, bn, bk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dw(const void* x, const void* g, const void* idx, const void* cnt,
              void* dw, int Mp, int K, int N, int width, int bn, int bk,
              void* stream) {
  const dim3 grid(N / bn, width);
  block_sparse_dw_kernel<T><<<grid, tile::kThreads, smem_bytes<T>(bk, bn),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const int*>(idx), static_cast<const int*>(cnt),
      static_cast<T*>(dw), Mp, K, N, width, bn, bk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2: g (Mp, N), w (K, N), dx (Mp, K) row-major in the entry's element
// type; ridx (K/bk, row_width), rcnt (K/bk,) int32.
extern "C" int block_sparse_dx_bf16(const void* g, const void* w, const void* ridx,
                                    const void* rcnt, void* dx, int Mp, int K, int N,
                                    int row_width, int bm, int bn, int bk, void* stream) {
  return launch_dx<__nv_bfloat16>(g, w, ridx, rcnt, dx, Mp, K, N, row_width, bm, bn,
                                  bk, stream);
}

extern "C" int block_sparse_dx_f32(const void* g, const void* w, const void* ridx,
                                   const void* rcnt, void* dx, int Mp, int K, int N,
                                   int row_width, int bm, int bn, int bk, void* stream) {
  return launch_dx<float>(g, w, ridx, rcnt, dx, Mp, K, N, row_width, bm, bn, bk, stream);
}

// K3: x (Mp, K), g (Mp, N), dw (K, N) zero-filled by the caller; idx
// (N/bn, width), cnt (N/bn,) int32.  Mp % 16 == 0.
extern "C" int block_sparse_dw_bf16(const void* x, const void* g, const void* idx,
                                    const void* cnt, void* dw, int Mp, int K, int N,
                                    int width, int bn, int bk, void* stream) {
  return launch_dw<__nv_bfloat16>(x, g, idx, cnt, dw, Mp, K, N, width, bn, bk, stream);
}

extern "C" int block_sparse_dw_f32(const void* x, const void* g, const void* idx,
                                   const void* cnt, void* dw, int Mp, int K, int N,
                                   int width, int bn, int bk, void* stream) {
  return launch_dw<float>(x, g, idx, cnt, dw, Mp, K, N, width, bn, bk, stream);
}
