// The grouped block-sparse kernels over a weight bank (the MoE experts'
// wi/wg/wo), all groups in one launch each:
//
//   K4 replaces repro/kernels/block_sparse_matmul.py::_g_fwd_kernel
//      (pallas_call in _g_fwd_call):  y[g] = x[g] @ W[g] over the stacked
//      CSC idx[g, j, :cnt[g, j]];
//   K5 replaces ::_g_dx_kernel (pallas_call in _g_dx_call):  dx[g] = g[g] @
//      W[g]^T over the stacked CSR ridx[g, k, :rcnt[g, k]];
//   K6 replaces ::_g_dw_kernel (pallas_call in _g_dw_call) and the
//      reference's vmapped _scatter_packed_dw:  dw[g] = x[g]^T @ g[g] on the
//      active blocks of the stacked (superset) CSC, zeros elsewhere;
//   K8 replaces ::_g_dw_fused_kernel (pallas_call in _g_dw_fused_call) and
//      the vmapped scatter of _gfbs_bwd:  the same blocks store the new SGD
//      momentum mu * mom[g] + x[g]^T g[g] + wd * w[g], optionally
//      stochastically rounded with the element id (g * K + row) * N + col.
//
// The TPU kernels' grids (G, ..., width) walked every padded slot of the
// shared width with a pl.when skip; here the group is the CTA grid's third
// dimension (times a split of K4's, K5's and K6's walks) and each CTA
// loops over exactly its own group's count (a lopsided expert widens only
// the packed arrays, not the other groups' loops).  K4 is K1's kernel on
// the GEMM core with the packed walk (block_sparse_fwd.cuh), K5/K6/K8 are
// K2/K3/K7's (block_sparse_bwd.cuh, on the GEMM core; a split of K4 or K5
// merged by masked_matmul.cu's masked_merge_<S>, of K6 or K8 by
// block_sparse_bwd.cu's block_sparse_dw_merge_<S> or
// block_sparse_dw_fused_merge_<...>);
// the designs, their traps (a dead expert writes zero outputs, zero dx
// rows and a zero dw; a group with no active block a zero m_new) and their
// bounds are there.
#include "block_sparse_bwd.cuh"
#include "block_sparse_fwd.cuh"

// K4: x (G, Mp, K), w (G, K, N) row-major in the entry's element type; idx
// (G, N/bn, width), cnt (G, N/bn) int32; y (G, Mp, N) like x.  (tm, tn) a
// built tile; with n_split > 1, part is the f32 workspace (n_split, G, Mp,
// N) and masked_matmul.cu's masked_merge_<S> must follow.
extern "C" int block_sparse_grouped_fwd_bf16(const void* x, const void* w, const void* idx,
                                             const void* cnt, void* y, void* part, int G,
                                             int Mp, int K, int N, int width, int bk, int bn,
                                             int tm, int tn, int n_split, void* stream) {
  return launch_block_sparse_fwd<__nv_bfloat16>(x, w, idx, cnt, y, part, G, Mp, K, N, width,
                                                bk, bn, tm, tn, n_split, stream);
}

extern "C" int block_sparse_grouped_fwd_f32(const void* x, const void* w, const void* idx,
                                            const void* cnt, void* y, void* part, int G,
                                            int Mp, int K, int N, int width, int bk, int bn,
                                            int tm, int tn, int n_split, void* stream) {
  return launch_block_sparse_fwd<float>(x, w, idx, cnt, y, part, G, Mp, K, N, width, bk, bn,
                                        tm, tn, n_split, stream);
}

// K5: g (G, Mp, N), w (G, K, N), dx (G, Mp, K) in the entry's element type;
// ridx (G, K/bk, width), rcnt (G, K/bk) int32.  (tm, tn) a built tile; with
// n_split > 1, part is the f32 workspace (n_split, G, Mp, K) and
// masked_matmul.cu's masked_merge_<S> must follow.
extern "C" int block_sparse_grouped_dx_bf16(const void* g, const void* w, const void* ridx,
                                            const void* rcnt, void* dx, void* part, int G,
                                            int Mp, int K, int N, int width, int bk, int bn,
                                            int tm, int tn, int n_split, void* stream) {
  return launch_block_sparse_dx<__nv_bfloat16>(g, w, ridx, rcnt, dx, part, G, Mp, K, N, width,
                                               bk, bn, tm, tn, n_split, stream);
}

extern "C" int block_sparse_grouped_dx_f32(const void* g, const void* w, const void* ridx,
                                           const void* rcnt, void* dx, void* part, int G,
                                           int Mp, int K, int N, int width, int bk, int bn,
                                           int tm, int tn, int n_split, void* stream) {
  return launch_block_sparse_dx<float>(g, w, ridx, rcnt, dx, part, G, Mp, K, N, width, bk, bn,
                                       tm, tn, n_split, stream);
}

// K6: x (G, Mp, K), g (G, Mp, N), dw (G, K, N) zero-filled by the caller;
// idx (G, N/bn, width), cnt (G, N/bn) int32.  Mp % 16 == 0; (tm, tn) a
// built wgrad tile that holds the (bk, bn) block; with n_split > 1, part is
// the f32 workspace (n_split, G, N/bn, width, bk, bn) and
// block_sparse_bwd.cu's block_sparse_dw_merge_<S> must follow.
extern "C" int block_sparse_grouped_dw_bf16(const void* x, const void* g, const void* idx,
                                            const void* cnt, void* dw, void* part, int G,
                                            int Mp, int K, int N, int width, int bk, int bn,
                                            int tm, int tn, int n_split, void* stream) {
  return launch_block_sparse_dw<__nv_bfloat16>(x, g, idx, cnt,
                                               epi::Out<__nv_bfloat16>{(__nv_bfloat16*)dw},
                                               part, G, Mp, K, N, width, bk, bn, tm, tn,
                                               n_split, stream);
}

extern "C" int block_sparse_grouped_dw_f32(const void* x, const void* g, const void* idx,
                                           const void* cnt, void* dw, void* part, int G,
                                           int Mp, int K, int N, int width, int bk, int bn,
                                           int tm, int tn, int n_split, void* stream) {
  return launch_block_sparse_dw<float>(x, g, idx, cnt, epi::Out<float>{(float*)dw}, part, G,
                                       Mp, K, N, width, bk, bn, tm, tn, n_split, stream);
}

// K8: block_sparse_grouped_dw_fused_<x/g/w type>_<mom type>_<output type>;
// x (G, Mp, K), g (G, Mp, N), w and mom (G, K, N), out (G, K, N) zero-filled
// by the caller; idx (G, N/bn, width), cnt (G, N/bn) int32.  Mp % 16 == 0;
// (tm, tn) a built wgrad tile that holds the (bk, bn) block; with n_split >
// 1, part is the f32 workspace (n_split, G, N/bn, width, bk, bn) and
// block_sparse_bwd.cu's block_sparse_dw_fused_merge_<...> must follow.
#define FUSED_ENTRY(S, T, SM, TM, SO, TO)                                              \
  extern "C" int block_sparse_grouped_dw_fused_##S##_##SM##_##SO(                      \
      const void* x, const void* g, const void* idx, const void* cnt, const void* w,   \
      const void* mom, void* out, void* part, int G, int Mp, int K, int N, int width,  \
      int bk, int bn, int tm, int tn, int n_split, unsigned seed, float mu, float wd,  \
      int sr, void* stream) {                                                          \
    return launch_block_sparse_dw<T>(                                                  \
        x, g, idx, cnt,                                                                \
        epi::momentum_epi<T, TM, TO, false>(nullptr, w, mom, out, seed, mu, wd, sr),   \
        part, G, Mp, K, N, width, bk, bn, tm, tn, n_split, stream);                    \
  }

FUSED_ENTRY(bf16, __nv_bfloat16, bf16, __nv_bfloat16, bf16, __nv_bfloat16)
FUSED_ENTRY(bf16, __nv_bfloat16, f32, float, bf16, __nv_bfloat16)
FUSED_ENTRY(bf16, __nv_bfloat16, bf16, __nv_bfloat16, f32, float)
FUSED_ENTRY(bf16, __nv_bfloat16, f32, float, f32, float)
FUSED_ENTRY(f32, float, bf16, __nv_bfloat16, f32, float)
FUSED_ENTRY(f32, float, f32, float, f32, float)
