// Masked matmul with the elementwise mask fused in, forward and backward:
// K13, K14, K15, their grouped twins K16, K17, K18, the fused SGD wgrad
// epilogue K19 and its grouped twin K20.
//
// Replaces eight TPU kernels of repro/kernels/masked_matmul.py:
//   K13 _fwd_kernel (pallas_call in _fwd_call)     y  = x @ (w * m)
//   K16 _g_fwd_kernel (_g_fwd_call)                y[g] = x[g] @ (w[g] * m[g])
//                                                   for every group g of a
//                                                   weight bank (the MoE
//                                                   experts), one launch
//   K14 _dx_kernel (_dx_call)                      dx = g @ (w * m)^T
//   K17 _g_dx_kernel (_g_dx_call)                  dx[g] = g[g] @ (w[g] * m[g])^T
//   K15 _dw_kernel (_dw_call)                      dw = (x^T @ g) * m
//   K18 _g_dw_kernel (_g_dw_call)                  dw[g] = (x[g]^T @ g[g]) * m[g]
//                                                   (m the Top-KAST superset
//                                                   on the training path)
//   K19 _dw_fused_kernel (_dw_fused_call)          m_new = (mu * mom + x^T @ g
//                                                   + wd * w) * m, optionally
//                                                   stochastically rounded to
//                                                   the bf16 grid (sr_to_bf16)
//   K20 _g_dw_fused_kernel (_g_dw_fused_call)      K19 for every group g of a
//                                                   bank, one launch
// m is a bool (one byte, 0 or 1) mask of w's shape (K, N): any pattern.
//
// Design.  The masked weight never exists in device memory: the forward and
// the dgrad stage a slab of w and the same slab of m and multiply them in
// shared memory (v * float(m), as the reference's w * m.astype(w.dtype): an
// inf or NaN weight under a zero mask gives NaN).  No atomics, every sum in
// a fixed order.
//  * All eight run one kernel body, masked_gemm_kernel, on the
//    register-resident GEMM core (gemm_core.cuh): a cp.async ring of (A, B,
//    mask) slabs of 32, mma.sync m16n8k16 for bf16 and 3xTF32 m16n8k8 for
//    f32 (f32's digits on the tensor cores), accumulators in registers, one
//    rounding at the store.  The forward (A = x, L = K, cols = N) stages w's
//    rows as B (gemm::MaskedRowsB); the dgrad (A = g, L = N, cols = K)
//    stages the w rows of dx's columns as they lie (gemm::MaskedColsB): w's
//    contiguous axis is the contraction, so the slab is already mma.sync's
//    n-major B operand, read by ldmatrix without .trans (f32: on 32-bit
//    pairs), and nothing is transposed.  Both apply the mask in place, in
//    shared memory, by the thread that copied the chunk.  The wgrads (A =
//    x^T, rows = K, L = Mp, cols = N) stage x's rows as they lie
//    (gemm::ColsA: ldmatrix.trans reads A) and g's rows as a dense B
//    (gemm::DenseRowsB), and apply the mask at the store, from the tile's
//    mask bytes that the CTA copies into shared memory ahead of its walk
//    (read at the store they add a memory round trip after the walk: 0.95
//    against 0.52 ms at qwen2-moe's 16-row banks on an H100, PERF.md).
//    One CTA per (BM-row tile, BN-column tile, group x split), the
//    forward's and the wgrads' grids walking column tiles fastest, the
//    dgrad's row tiles (the row tiles that read one w tile run side by
//    side: a bank's tile comes from HBM about once).
//  * The store is an epilogue policy of the kernel (Out, MaskedOut and
//    Momentum with the mask, in epilogue.cuh, whose Out and unmasked
//    Momentum the block-sparse wgrads K3/K6 and K7/K8 take): the forward
//    and the dgrad round the sum once; K15
//    and K18 multiply it by the mask byte (acc * float(m), as the
//    reference's acc * m.astype(f32): an inf or NaN sum under a zero mask
//    gives NaN); K19 and K20 store the new momentum (mu * mom + acc + wd *
//    w) * float(m) (the reference's order of f32
//    operations, no contraction), reading the pair's mom and w with one
//    paired load each, and with sr round it by sr_to_bf16 on the element's
//    id gid = (g * K + row) * N + col (wrapping uint32; K and N are the
//    padded extents the wrapper hands in), into the output type (w's on
//    the training path, f32 for a check before the rounding).  After its
//    walk a K19/K20 CTA copies its tile's w and mom rows into the ring's
//    shared memory, free by then, where both tiles fit there, and folds the
//    momentum from shared memory; where they do not fit (bf16 w with f32
//    mom, on both wgrad tiles) it reads them from global memory at the fold.
//  * The host plan (kernels/masked_matmul.py::fwd_plan, one plan for the
//    directions on (rows, contraction, cols); K19/K20 on the fused
//    kernel's own resident CTAs) picks the tile and splits the contraction
//    into n_split whole-slab parts where the grid alone would leave the
//    SMs' resident slots empty (decode) or its last wave mostly idle; a
//    split stores f32 partials, unmasked for the wgrads, into a workspace
//    (n_split, G, rows, cols), and masked_merge_kernel sums them in split
//    order and applies the same epilogue (the mask after the ordered sum;
//    for K19/K20 the momentum, the mask and sr), rounding once.  K16, K17,
//    K18 and K20 are K13, K14, K15 and K19 with the bank's group in grid
//    dim z (K13-K15 and K19 are the bank of one).  A fully masked expert
//    reads its zero mask like any other: zero dx rows and a zero dw or
//    m_new, no empty sum.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16, 495 TF32, 67 f32 FFMA):
// decode (16 padded rows) reads every weight and its mask byte once, far
// below the ridge: bytes bound it, and split-K keeps enough copies in
// flight.  The training shapes (M = 2048) do the dense work, 2 * M * K * N
// flops per call: in bf16 near the ridge; in f32 (the reference's MLP)
// 3xTF32 does three tensor-core products per f32 product.  K19/K20 add the
// reads of mom and w and the write of m_new: about 6 bytes a weight more
// than K15/K18.  The times against the bound are in PERF.md.
#include <algorithm>

#include "common.cuh"
#include "epilogue.cuh"
#include "gemm_launch.cuh"

namespace {

using epi::MaskedOut;
using epi::Out;

// The wgrads' store reads the mask of its output tile: a CTA stages it
// beside the ring (BM rows of BN bytes, padded by 16 so that a warp's
// reads at the store, rows g and byte pairs 2t, fall in distinct banks), in
// a cp.async group of its own ahead of the walk's, so that its latency
// hides under the walk.
template <class C> constexpr int kTileMaskLd = C::BN + 16;
template <class C>
constexpr int smem_bytes_of() {
  return C::SMEM + (C::StageB::kMasked ? 0 : C::BM * kTileMaskLd<C>);
}

template <class C>
__device__ __forceinline__ void load_tile_mask(uint32_t dst, const uint8_t* m, int rows, int cols,
                                               int m0, int n0) {
  constexpr int per_row = C::BN / 16, n = C::BM * per_row;
#pragma unroll
  for (int i = 0; i < (n + C::kThreads - 1) / C::kThreads; ++i) {
    const int c = threadIdx.x + i * C::kThreads;
    if (n % C::kThreads == 0 || c < n) {
      const int r = c / per_row, col = (c % per_row) * 16;
      const bool ok = m0 + r < rows && n0 + col < cols;
      ptx::cp_async16(dst + r * kTileMaskLd<C> + col,
                      m + (ok ? (size_t)(m0 + r) * cols + n0 + col : 0), ok);
    }
  }
  ptx::cp_async_commit();
}

// K13/K16 (C::StageB = MaskedRowsB: a = x (G, rows = Mp, L = K), b = w
// and m (G, L, cols = N)), K14/K17 (MaskedColsB: a = g (G, rows = Mp, L =
// N), b = w and m (G, cols = K, L)) and K15/K18, K19/K20 (DenseRowsB,
// ColsA: a = x (G, L = Mp, rows = K), b = g (G, L, cols = N), m (G, rows,
// cols)); the outputs (G, rows, cols) by the epilogue policy Epi;
// blockIdx.z = group * n_split + s.  Split s walks L's slabs [s n /
// n_split, (s + 1) n / n_split) of n = ceil(L / 32) and, when n_split > 1,
// stores its f32 partial (for the wgrads unmasked) into part (n_split, G,
// rows, cols) in place of the epilogue's store.
template <class C, class Epi>
__global__ void __launch_bounds__(C::kThreads, C::MIN_CTAS)
masked_gemm_kernel(const typename C::Type* __restrict__ a,
                   const typename C::Type* __restrict__ b, const uint8_t* __restrict__ m,
                   const Epi epi, float* __restrict__ part, int G, int rows, int L, int cols,
                   int n_split) {
  using T = typename C::Type;
  constexpr bool kMaskB = C::StageB::kMasked;  // else the mask is applied at the store
  extern __shared__ __align__(128) unsigned char smem[];
  const int g = blockIdx.z / n_split, s = blockIdx.z % n_split;
  const int n_slabs = (L + gemm::kSlab - 1) / gemm::kSlab;
  const bool rows_fastest = C::StageB::kRowTilesFastest;
  const int m0 = (rows_fastest ? blockIdx.x : blockIdx.y) * C::BM;
  const int n0 = (rows_fastest ? blockIdx.y : blockIdx.x) * C::BN;
  const size_t plane0 = (size_t)g * rows * cols;
  const uint8_t* mg = m + (size_t)g * (kMaskB ? L : rows) * cols;
  unsigned char* tile_mask = smem + C::SMEM;  // the wgrads' (kTileMaskLd)
  if constexpr (!kMaskB) load_tile_mask<C>(ptx::smem_addr(tile_mask), mg, rows, cols, m0, n0);
  const T* ag = a + (size_t)g * rows * L;
  const T* bg = b + (size_t)g * L * cols;
  const int s0 = s * n_slabs / n_split, s1 = (s + 1) * n_slabs / n_split;
  gemm::Warp<C> warp;
  warp.zero();
  const int lda = C::StageA::dense_ld(rows, L), ldb = C::StageB::dense_ld(L, cols);
  gemm::walk<C>(warp, ag, lda, bg, ldb, mg, rows, cols, L, m0, n0, s0, s1, smem);
  if constexpr (sizeof(T) == 4) {
    // a NaN in f32's sums: an inf or NaN input; walk again with the exact
    // split, which keeps an inf operand's products inf (gemm_core.cuh)
    if (__syncthreads_or(warp.any_nan())) {
      warp.zero();
      gemm::walk<C, true>(warp, ag, lda, bg, ldb, mg, rows, cols, L, m0, n0, s0, s1, smem);
    }
  }
  if (n_split == 1) {
    epi.template fold<C>(warp, plane0, cols, rows, cols, m0, n0, smem);
    gemm::store(warp, rows, cols, m0, n0, [&](int r, int c, float v0, float v1) {
      unsigned mb = 0;  // the pair's two mask bytes (c even)
      if constexpr (!kMaskB)
        mb = *reinterpret_cast<const uint16_t*>(tile_mask + (r - m0) * kTileMaskLd<C> + c - n0);
      epi.pair(plane0 + (size_t)r * cols + c, v0, v1, mb);
    });
  } else {
    float* pg = part + ((size_t)s * G + g) * rows * cols;
    gemm::store(warp, rows, cols, m0, n0, [&](int r, int c, float v0, float v1) {
      gemm::store2(pg + (size_t)r * cols + c, v0, v1);
    });
  }
}

// The split merge: out[i] = Epi's store of (sum over s of part[s][i], s =
// 0, 1, ... in order), rounded once -- the sum for K13, K14, K16, K17, times
// the mask for K15, K18 (an overflowed sum under a zero mask gives NaN, as
// in the unsplit kernel), the momentum epilogue for K19, K20; plane = G *
// rows * cols (a multiple of 4), n4 = plane / 4, the mask 4-byte aligned.
// At most 64 registers a thread (4 CTAs an SM): left to itself ptxas held
// the momentum merges of a bf16 w to 32 and spilled.
template <class Epi>
__global__ void __launch_bounds__(256, 4)
masked_merge_kernel(const float* __restrict__ part, const Epi epi, size_t n4, size_t plane,
                    int n_split) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 v = reinterpret_cast<const float4*>(part)[i];
    for (int s = 1; s < n_split; ++s) {
      const float4 p = reinterpret_cast<const float4*>(part + s * plane)[i];
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    epi.quad(4 * i, v);
  }
}

template <class C, class Epi>
int launch_gemm(const void* a, const void* b, const void* m, const Epi& epi, void* part, int G,
                int rows, int L, int cols, int n_split, void* stream) {
  using T = typename C::Type;
  const auto kernel = masked_gemm_kernel<C, Epi>;
  cudaError_t err = gemm::prepare(kernel, smem_bytes_of<C>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned row_tiles = (rows + C::BM - 1) / C::BM, col_tiles = (cols + C::BN - 1) / C::BN;
  const dim3 grid(C::StageB::kRowTilesFastest ? row_tiles : col_tiles,
                  C::StageB::kRowTilesFastest ? col_tiles : row_tiles, G * n_split);
  kernel<<<grid, C::kThreads, smem_bytes_of<C>(), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const uint8_t*>(m), epi,
      static_cast<float*>(part), G, rows, L, cols, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <class Epi>
int launch_merge(const void* part, const Epi& epi, long long plane, int n_split, void* stream) {
  const size_t n4 = static_cast<size_t>(plane) / 4;
  const int blocks = static_cast<int>(std::min<size_t>((n4 + 255) / 256, 132 * 8));
  masked_merge_kernel<Epi><<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), epi, n4, static_cast<size_t>(plane), n_split);
  return static_cast<int>(cudaGetLastError());
}

// out: gemm::launch_info of configuration C with the epilogue Epi.
template <class C, class Epi>
int gemm_info(int* out) {
  return gemm::launch_info(masked_gemm_kernel<C, Epi>, smem_bytes_of<C>(), C::kThreads, out);
}

}  // namespace

// masked_<dir>_<S> for dir = fwd (K13, K16: B staged by MaskedRowsB), dx
// (K14, K17: MaskedColsB) and dw (K15, K18: DenseRowsB, A by ColsA), on a
// bank of G groups (K13-K15 pass G = 1), row-major, m one byte per element
// (0 or 1); the forward takes x (G, Mp, K), w and m (G, K, N) and writes y
// (G, Mp, N); the dgrad takes g (G, Mp, N), w and m (G, K, N) and writes dx
// (G, Mp, K); the wgrad takes x (G, Mp, K), g (G, Mp, N) and m (G, K, N)
// and writes dw (G, K, N).  K and N multiples of 16, 16-byte alignment;
// (bm, bn) one of the built tiles (bn: the tile's columns, N for the
// forward and the wgrad, K for the dgrad; bm: the wgrad's over K); with
// n_split > 1, part is the f32 workspace (n_split, G, rows, columns) and
// masked_merge_<S> (masked_dw_merge_<S> after the wgrad, with m) must
// follow to write the output.  masked_<dir>_info_<S>: the launch of tile
// (bm, bn).
#define GEMM_ENTRIES(S, T)                                                             \
  extern "C" int masked_fwd_##S(const void* x, const void* w, const void* m,           \
                                void* y, void* part, int G, int Mp, int K, int N,      \
                                int bm, int bn, int n_split, void* stream) {           \
    return gemm::with_tile<T, gemm::MaskedRowsB>(bm, bn, [&](auto tag) {               \
      return launch_gemm<typename decltype(tag)::type>(x, w, m, Out<T>{(T*)y}, part, G, \
                                                       Mp, K, N, n_split, stream);     \
    });                                                                                \
  }                                                                                    \
  extern "C" int masked_dx_##S(const void* g, const void* w, const void* m,            \
                               void* dx, void* part, int G, int Mp, int K, int N,      \
                               int bm, int bn, int n_split, void* stream) {            \
    return gemm::with_tile<T, gemm::MaskedColsB>(bm, bn, [&](auto tag) {               \
      return launch_gemm<typename decltype(tag)::type>(g, w, m, Out<T>{(T*)dx}, part,  \
                                                       G, Mp, N, K, n_split, stream);  \
    });                                                                                \
  }                                                                                    \
  extern "C" int masked_dw_##S(const void* x, const void* g, const void* m,            \
                               void* dw, void* part, int G, int Mp, int K, int N,      \
                               int bm, int bn, int n_split, void* stream) {            \
    const MaskedOut<T> epi{(T*)dw, (const uint8_t*)m};                                 \
    return gemm::with_tile<T, gemm::DenseRowsB, gemm::ColsA>(bm, bn, [&](auto tag) {   \
      return launch_gemm<typename decltype(tag)::type>(x, g, m, epi, part, G, K, Mp,   \
                                                       N, n_split, stream);            \
    });                                                                                \
  }                                                                                    \
  extern "C" int masked_merge_##S(const void* part, void* y, long long plane,          \
                                  int n_split, void* stream) {                         \
    return launch_merge(part, Out<T>{(T*)y}, plane, n_split, stream);                  \
  }                                                                                    \
  extern "C" int masked_dw_merge_##S(const void* part, const void* m, void* dw,        \
                                     long long plane, int n_split, void* stream) {     \
    return launch_merge(part, MaskedOut<T>{(T*)dw, (const uint8_t*)m}, plane, n_split, \
                        stream);                                                       \
  }                                                                                    \
  extern "C" int masked_fwd_info_##S(int bm, int bn, int* out) {                       \
    return gemm::with_tile<T, gemm::MaskedRowsB>(bm, bn, [&](auto tag) {               \
      return gemm_info<typename decltype(tag)::type, Out<T>>(out);                     \
    });                                                                                \
  }                                                                                    \
  extern "C" int masked_dx_info_##S(int bm, int bn, int* out) {                        \
    return gemm::with_tile<T, gemm::MaskedColsB>(bm, bn, [&](auto tag) {               \
      return gemm_info<typename decltype(tag)::type, Out<T>>(out);                     \
    });                                                                                \
  }                                                                                    \
  extern "C" int masked_dw_info_##S(int bm, int bn, int* out) {                        \
    return gemm::with_tile<T, gemm::DenseRowsB, gemm::ColsA>(bm, bn, [&](auto tag) {   \
      return gemm_info<typename decltype(tag)::type, MaskedOut<T>>(out);               \
    });                                                                                \
  }

GEMM_ENTRIES(bf16, __nv_bfloat16)
GEMM_ENTRIES(f32, float)

// K19 and K20: masked_dw_fused_<x/g/w type>_<mom type>_<output type> takes
// x (G, Mp, K), g (G, Mp, N), wgm, w and mom (G, K, N) (K19 passes G = 1)
// and writes the new momentum out (G, K, N), on the wgrad's walk (its
// tiles, bm over K and bn over N); with n_split > 1 part is the f32
// workspace (n_split, G, K, N) and masked_dw_fused_merge_<...> (the
// ordered sum, then the same epilogue) must follow to write out, which
// it takes with plane = G K N.  masked_dw_fused_info_<...>: the launch of
// tile (bm, bn).
#define FUSED_ENTRY(S, T, SM, TM, SO, TO)                                              \
  extern "C" int masked_dw_fused_##S##_##SM##_##SO(                                    \
      const void* x, const void* g, const void* wgm, const void* w, const void* mom,   \
      void* out, void* part, int G, int Mp, int K, int N, int bm, int bn, int n_split, \
      unsigned seed, float mu, float wd, int sr, void* stream) {                       \
    const auto policy =                                                                \
        epi::momentum_epi<T, TM, TO, true>(wgm, w, mom, out, seed, mu, wd, sr);        \
    return gemm::with_tile<T, gemm::DenseRowsB, gemm::ColsA>(bm, bn, [&](auto tag) {   \
      return launch_gemm<typename decltype(tag)::type>(x, g, wgm, policy, part, G, K,  \
                                                       Mp, N, n_split, stream);        \
    });                                                                                \
  }                                                                                    \
  extern "C" int masked_dw_fused_merge_##S##_##SM##_##SO(                              \
      const void* part, const void* wgm, const void* w, const void* mom, void* out,    \
      long long plane, int n_split, unsigned seed, float mu, float wd, int sr,         \
      void* stream) {                                                                  \
    return launch_merge(                                                               \
        part, epi::momentum_epi<T, TM, TO, true>(wgm, w, mom, out, seed, mu, wd, sr),  \
        plane, n_split, stream);                                                       \
  }                                                                                    \
  extern "C" int masked_dw_fused_info_##S##_##SM##_##SO(int bm, int bn, int* out) {    \
    return gemm::with_tile<T, gemm::DenseRowsB, gemm::ColsA>(bm, bn, [&](auto tag) {   \
      return gemm_info<typename decltype(tag)::type,                                   \
                       epi::Momentum<T, TM, TO, true>>(out);                           \
    });                                                                                \
  }

FUSED_ENTRY(bf16, __nv_bfloat16, bf16, __nv_bfloat16, bf16, __nv_bfloat16)
FUSED_ENTRY(bf16, __nv_bfloat16, f32, float, bf16, __nv_bfloat16)
FUSED_ENTRY(bf16, __nv_bfloat16, bf16, __nv_bfloat16, f32, float)
FUSED_ENTRY(bf16, __nv_bfloat16, f32, float, f32, float)
FUSED_ENTRY(f32, float, bf16, __nv_bfloat16, f32, float)
FUSED_ENTRY(f32, float, f32, float, f32, float)
