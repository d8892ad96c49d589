// K1: block-sparse forward matmul  y = x @ W  over the active (bk, bn) blocks
// of one weight matrix W.
//
// Replaces the TPU kernel repro/kernels/block_sparse_matmul.py::_fwd_kernel
// (pallas_call in _fwd_call).  The kernel, its design, its traps and its
// bound are in block_sparse_fwd.cuh, shared with the grouped K4: K1 is its
// bank of one group, on the GEMM core (gemm_core.cuh) with the packed walk.
#include "block_sparse_fwd.cuh"

// block_sparse_fwd_<S>: x (Mp, K), w (K, N) row-major in the entry's
// element type; idx (N/bn, width), cnt (N/bn,) int32; y (Mp, N) like x.
// (tm, tn) a built tile; with n_split > 1, part is the f32 workspace
// (n_split, 1, Mp, N) and the masked forward's merge (masked_matmul.cu's
// masked_merge_<S>) must follow.  block_sparse_fwd_info_<S>: the launch of
// the kernel on (tm, tn) with a list of ``width`` ids (K4's is the same
// kernel).
#define FWD_ENTRIES(S, T)                                                                  \
  extern "C" int block_sparse_fwd_##S(const void* x, const void* w, const void* idx,      \
                                      const void* cnt, void* y, void* part, int Mp, int K, \
                                      int N, int width, int bk, int bn, int tm, int tn,    \
                                      int n_split, void* stream) {                         \
    return launch_block_sparse_fwd<T>(x, w, idx, cnt, y, part, 1, Mp, K, N, width, bk,    \
                                      bn, tm, tn, n_split, stream);                        \
  }                                                                                        \
  extern "C" int block_sparse_fwd_info_##S(int tm, int tn, int width, int* out) {         \
    return block_sparse_fwd_info<T>(tm, tn, width, out);                                   \
  }

FWD_ENTRIES(bf16, __nv_bfloat16)
FWD_ENTRIES(f32, float)
