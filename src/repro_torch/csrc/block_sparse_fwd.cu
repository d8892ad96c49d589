// K1: block-sparse forward matmul  y = x @ W  over the active (bk, bn) blocks
// of one weight matrix W.
//
// Replaces the TPU kernel repro/kernels/block_sparse_matmul.py::_fwd_kernel
// (pallas_call in _fwd_call).  The kernel, its design, its traps and its
// bound are in block_sparse_fwd.cuh, shared with the grouped K4: K1 is its
// bank of one group.
#include "block_sparse_fwd.cuh"

// x (Mp, K), w (K, N) row-major in the entry's element type; idx (N/bn,
// width), cnt (N/bn,) int32; y (Mp, N) like x.
extern "C" int block_sparse_fwd_bf16(const void* x, const void* w, const void* idx,
                                     const void* cnt, void* y, int Mp, int K, int N,
                                     int width, int bm, int bn, int bk, void* stream) {
  return launch_block_sparse_fwd<__nv_bfloat16>(x, w, idx, cnt, y, 1, Mp, K, N,
                                                width, bm, bn, bk, stream);
}

extern "C" int block_sparse_fwd_f32(const void* x, const void* w, const void* idx,
                                    const void* cnt, void* y, int Mp, int K, int N,
                                    int width, int bm, int bn, int bk, void* stream) {
  return launch_block_sparse_fwd<float>(x, w, idx, cnt, y, 1, Mp, K, N, width, bm,
                                        bn, bk, stream);
}
