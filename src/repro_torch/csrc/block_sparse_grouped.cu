// K4: grouped block-sparse forward matmul  y[g] = x[g] @ W[g]  over a weight
// bank (the MoE experts' wi/wg/wo), all groups in one launch.
//
// Replaces the TPU kernel repro/kernels/block_sparse_matmul.py::_g_fwd_kernel
// (pallas_call in _g_fwd_call).  The TPU kernel's grid (G, M/bm, N/bn,
// width) walked every padded slot of the shared width with a pl.when skip;
// here the group is the CTA grid's third dimension and each CTA loops over
// exactly cnt[g, j] active blocks (a lopsided expert widens only the
// packed arrays, not the other groups' loops).  The kernel, its design, its
// traps (a dead expert writes zeros) and its bound are in
// block_sparse_fwd.cuh, shared with K1.
#include "block_sparse_fwd.cuh"

// x (G, Mp, K), w (G, K, N) row-major in the entry's element type; idx (G,
// N/bn, width), cnt (G, N/bn) int32; y (G, Mp, N) like x.
extern "C" int block_sparse_grouped_fwd_bf16(const void* x, const void* w,
                                             const void* idx, const void* cnt, void* y,
                                             int G, int Mp, int K, int N, int width,
                                             int bm, int bn, int bk, void* stream) {
  return launch_block_sparse_fwd<__nv_bfloat16>(x, w, idx, cnt, y, G, Mp, K, N,
                                                width, bm, bn, bk, stream);
}

extern "C" int block_sparse_grouped_fwd_f32(const void* x, const void* w,
                                            const void* idx, const void* cnt, void* y,
                                            int G, int Mp, int K, int N, int width,
                                            int bm, int bn, int bk, void* stream) {
  return launch_block_sparse_fwd<float>(x, w, idx, cnt, y, G, Mp, K, N, width, bm,
                                        bn, bk, stream);
}
