// The launch side of the GEMM core (gemm_core.cuh), shared by the kernels
// built on it: the masked matmuls K13-K20 (masked_matmul.cu), the
// block-sparse wgrad K3/K6, its fused K7/K8 and the dgrad K2/K5
// (block_sparse_bwd.cuh, in block_sparse_bwd.cu and
// block_sparse_grouped.cu) and the block-sparse forward K1/K4
// (block_sparse_fwd.cuh, in block_sparse_fwd.cu and
// block_sparse_grouped.cu).  The CTA configurations of each built tile,
// the dispatch from a host plan's tile to its configuration, the shared
// bytes of a packed walk's list, the paired stores of the epilogues, the
// kernel attributes set before a launch, and the launch's resources read
// back from the runtime.
#pragma once
#include <cuda_runtime.h>

#include <type_traits>

#include "gemm_core.cuh"

namespace gemm {

// The (BM, BN) tiles the host plans pick from
// (kernels/masked_matmul.py::FWD_TILES): 128 x 128 for more than 64 rows
// (128 x 64 where the caller caps the column tile, a bf16 wgrad walks one
// slab, or a block-sparse wgrad's blocks are at most 64 wide), 16 x 64 for
// decode (not the wgrads': their rows are K); WM x WN warps, ring stages,
// resident CTAs an SM.  The forward (StageB = MaskedRowsB), the dgrad
// (MaskedColsB), the wgrads (DenseRowsB, StageA = ColsA), the block-sparse
// forward (DenseRowsB, RowsA) and the block-sparse dgrad (DenseColsB,
// RowsA) share the numbers.
template <typename T, int BM, int BN, class StageB, class StageA> struct TileCfg;
template <class B, class A> struct TileCfg<__nv_bfloat16, 128, 128, B, A> {
  using C = Cfg<__nv_bfloat16, 128, 128, 2, 4, 4, 2, B, A>;
};
template <class B, class A> struct TileCfg<__nv_bfloat16, 128, 64, B, A> {
  using C = Cfg<__nv_bfloat16, 128, 64, 4, 2, 4, 2, B, A>;
};
template <class B, class A> struct TileCfg<__nv_bfloat16, 16, 64, B, A> {
  using C = Cfg<__nv_bfloat16, 16, 64, 1, 4, 4, 4, B, A>;
};
template <class B, class A> struct TileCfg<float, 128, 128, B, A> {
  using C = Cfg<float, 128, 128, 2, 4, 4, 1, B, A>;
};
template <class B, class A> struct TileCfg<float, 128, 64, B, A> {
  using C = Cfg<float, 128, 64, 4, 2, 3, 1, B, A>;
};
template <class B, class A> struct TileCfg<float, 16, 64, B, A> {
  using C = Cfg<float, 16, 64, 1, 4, 4, 4, B, A>;
};

template <class C> struct Tag { using type = C; };

// The dynamic shared bytes of a packed walk's configuration C (K1/K4, K2/K5)
// with a list of ``width`` block ids staged after the ring.
template <class C>
int packed_smem_bytes(int width) {
  return C::SMEM + 4 * ((width + 3) / 4 * 4);
}

// f(Tag<Cfg>) for the configuration of tile (bm, bn) with B staged by
// StageB and A by StageA; cudaErrorInvalidValue for a tile that is not
// built.  A wgrad (StageA = ColsA) has no 16-row tile: its rows are K,
// never a decode's (kernels/masked_matmul.py::DW_TILES).
template <typename T, class StageB, class StageA = RowsA, class F>
int with_tile(int bm, int bn, F f) {
  if (bm == 128 && bn == 128) return f(Tag<typename TileCfg<T, 128, 128, StageB, StageA>::C>{});
  if (bm == 128 && bn == 64) return f(Tag<typename TileCfg<T, 128, 64, StageB, StageA>::C>{});
  if constexpr (std::is_same<StageA, RowsA>::value)
    if (bm == 16 && bn == 64) return f(Tag<typename TileCfg<T, 16, 64, StageB, StageA>::C>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// Two (or four) consecutive outputs of a row, rounded once: float2 or
// bf16x2 (float4 or 4 x bf16) stores, aligned to their width.
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<uint32_t*>(p) = ptx::pack_bf16(v0, v1);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(ptx::pack_bf16(v.x, v.y), ptx::pack_bf16(v.z, v.w));
}

// Before a launch: the kernel's dynamic shared bytes, and shared memory
// preferred over L1.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// out = {CTAs resident per SM, registers a thread, dynamic shared bytes,
// local (spill) bytes a thread, threads a CTA} of a kernel launched with
// `threads` threads and `smem` dynamic shared bytes.
template <typename Kernel>
int launch_info(Kernel kernel, int smem, int threads, int* out) {
  cudaError_t err = prepare(kernel, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = ctas;
  out[1] = attr.numRegs;
  out[2] = smem;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = threads;
  return 0;
}

}  // namespace gemm
