// Block-sparse backward: dgrad (K2), packed wgrad (K3) and packed wgrad
// with the fused SGD epilogue (K7) of y = x @ W.
//
// K2 replaces repro/kernels/block_sparse_matmul.py::_dx_kernel (pallas_call
// in _dx_call):  dx (M, K) = g (M, N) @ W^T over the active N-blocks of each
// K-block row, read from the CSR view ridx[k, :rcnt[k]] (core/pack.py).
// K3 replaces ::_dw_kernel (pallas_call in _dw_call):  for every active
// block (idx[j, s], j) of a CSC pack (the Top-KAST superset bidx/bcnt on the
// training path) dw[block] = x[:, k-block]^T @ g[:, j-block], summed over
// all M rows, written into the zeroed dense dw.
// K7 replaces ::_dw_fused_kernel (pallas_call in _dw_fused_call) and the
// _scatter_packed_dw of _fbs_bwd:  the same blocks store the new SGD
// momentum mu * mom + x^T g + wd * w instead of dw (optionally
// stochastically rounded to the bf16 grid), so the raw dw never reaches
// memory.  The kernels, their design, their traps and their bound are in
// block_sparse_bwd.cuh, shared with the grouped K5/K6/K8: K2/K3/K7 are
// their bank of one group.  All three run on the GEMM core (gemm_core.cuh);
// K7 is K3's kernel with the momentum epilogue policy (epilogue.cuh).
#include "block_sparse_bwd.cuh"

// block_sparse_dx_<S> (K2): g (Mp, N), w (K, N), dx (Mp, K) row-major in
// the entry's element type; ridx (K/bk, width), rcnt (K/bk,) int32.  (tm,
// tn) a built tile; with n_split > 1, part is the f32 workspace (n_split,
// 1, Mp, K) and the masked forward's merge (masked_matmul.cu's
// masked_merge_<S>) must follow.  block_sparse_dx_info_<S>: the launch of
// the kernel on (tm, tn) with a list of ``width`` ids (K5's is the same
// kernel).
#define DX_ENTRIES(S, T)                                                                   \
  extern "C" int block_sparse_dx_##S(const void* g, const void* w, const void* ridx,      \
                                     const void* rcnt, void* dx, void* part, int Mp, int K, \
                                     int N, int width, int bk, int bn, int tm, int tn,     \
                                     int n_split, void* stream) {                          \
    return launch_block_sparse_dx<T>(g, w, ridx, rcnt, dx, part, 1, Mp, K, N, width, bk,  \
                                     bn, tm, tn, n_split, stream);                         \
  }                                                                                        \
  extern "C" int block_sparse_dx_info_##S(int tm, int tn, int width, int* out) {          \
    return block_sparse_dx_info<T>(tm, tn, width, out);                                    \
  }

DX_ENTRIES(bf16, __nv_bfloat16)
DX_ENTRIES(f32, float)

// K3: x (Mp, K), g (Mp, N), dw (K, N) zero-filled by the caller; idx
// (N/bn, width), cnt (N/bn,) int32.  Mp % 16 == 0; (tm, tn) a built wgrad
// tile that holds the (bk, bn) block; with n_split > 1, part is the f32
// workspace (n_split, 1, N/bn, width, bk, bn) and block_sparse_dw_merge_<S>
// must follow.
// block_sparse_dw_merge_<S> (after K3 and K6): the ordered sum of the
// packed partials of a bank of G groups (G = 1 after K3) into dw's live
// blocks.  block_sparse_dw_info_<S>: the launch of the wgrad on (tm, tn).
#define DW_ENTRIES(S, T)                                                                 \
  extern "C" int block_sparse_dw_##S(const void* x, const void* g, const void* idx,     \
                                     const void* cnt, void* dw, void* part, int Mp,     \
                                     int K, int N, int width, int bk, int bn, int tm,   \
                                     int tn, int n_split, void* stream) {               \
    return launch_block_sparse_dw<T>(x, g, idx, cnt, epi::Out<T>{(T*)dw}, part, 1, Mp,  \
                                     K, N, width, bk, bn, tm, tn, n_split, stream);     \
  }                                                                                      \
  extern "C" int block_sparse_dw_merge_##S(const void* part, const void* idx,           \
                                           const void* cnt, void* dw, int G, int K,     \
                                           int N, int width, int bk, int bn,            \
                                           int n_split, void* stream) {                 \
    return launch_block_sparse_dw_merge(block_sparse_dw_merge_kernel<epi::Out<T>>, part, \
                                        idx, cnt, epi::Out<T>{(T*)dw}, G, K, N, width,  \
                                        bk, bn, n_split, stream);                       \
  }                                                                                      \
  extern "C" int block_sparse_dw_info_##S(int tm, int tn, int* out) {                   \
    return block_sparse_dw_info<T, epi::Out<T>>(tm, tn, out);                            \
  }

DW_ENTRIES(bf16, __nv_bfloat16)
DW_ENTRIES(f32, float)

// K7: block_sparse_dw_fused_<x/g/w type>_<mom type>_<output type>; x (Mp,
// K), g (Mp, N), w and mom (K, N), out (K, N) zero-filled by the caller;
// idx (N/bn, width), cnt (N/bn,) int32 (the wgrad pack: the Top-KAST
// superset on the training path).  Mp % 16 == 0; (tm, tn) a built wgrad
// tile that holds the (bk, bn) block; with n_split > 1, part is the f32
// workspace (n_split, 1, N/bn, width, bk, bn) and
// block_sparse_dw_fused_merge_<...> must follow.
// block_sparse_dw_fused_merge_<...> (after K7 and K8): the ordered sum of
// the packed partials of a bank of G groups (G = 1 after K7), then the
// momentum epilogue (sr, one rounding), into out's live blocks.
// block_sparse_dw_fused_info_<...>: the launch of the fused wgrad on (tm,
// tn) (K8's is the same kernel).
#define FUSED_ENTRY(S, T, SM, TM, SO, TO)                                                \
  extern "C" int block_sparse_dw_fused_##S##_##SM##_##SO(                              \
      const void* x, const void* g, const void* idx, const void* cnt, const void* w,   \
      const void* mom, void* out, void* part, int Mp, int K, int N, int width, int bk, \
      int bn, int tm, int tn, int n_split, unsigned seed, float mu, float wd, int sr,  \
      void* stream) {                                                                  \
    return launch_block_sparse_dw<T>(                                                  \
        x, g, idx, cnt,                                                                \
        epi::momentum_epi<T, TM, TO, false>(nullptr, w, mom, out, seed, mu, wd, sr),   \
        part, 1, Mp, K, N, width, bk, bn, tm, tn, n_split, stream);                    \
  }                                                                                    \
  extern "C" int block_sparse_dw_fused_merge_##S##_##SM##_##SO(                        \
      const void* part, const void* idx, const void* cnt, const void* w,               \
      const void* mom, void* out, int G, int K, int N, int width, int bk, int bn,      \
      int n_split, unsigned seed, float mu, float wd, int sr, void* stream) {          \
    return launch_block_sparse_dw_merge(                                               \
        block_sparse_dw_fused_merge_kernel<epi::Momentum<T, TM, TO, false>>, part, idx, \
        cnt, epi::momentum_epi<T, TM, TO, false>(nullptr, w, mom, out, seed, mu, wd, sr), \
        G, K, N, width, bk, bn, n_split, stream);                                      \
  }                                                                                    \
  extern "C" int block_sparse_dw_fused_info_##S##_##SM##_##SO(int tm, int tn,          \
                                                              int* out) {              \
    return block_sparse_dw_info<T, epi::Momentum<T, TM, TO, false>>(tm, tn, out);      \
  }

FUSED_ENTRY(bf16, __nv_bfloat16, bf16, __nv_bfloat16, bf16, __nv_bfloat16)
FUSED_ENTRY(bf16, __nv_bfloat16, f32, float, bf16, __nv_bfloat16)
FUSED_ENTRY(bf16, __nv_bfloat16, bf16, __nv_bfloat16, f32, float)
FUSED_ENTRY(bf16, __nv_bfloat16, f32, float, f32, float)
FUSED_ENTRY(f32, float, bf16, __nv_bfloat16, f32, float)
FUSED_ENTRY(f32, float, f32, float, f32, float)
