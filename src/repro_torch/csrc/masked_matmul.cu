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
// Design.  The masked weight never exists in device memory: each kernel
// stages a slab of w and the same slab of m and multiplies them in shared
// memory (v * float(m), as the reference's w * m.astype(w.dtype): an inf or
// NaN weight under a zero mask gives NaN).  No atomics, every sum in a
// fixed order.
//  * K13, K14, K15 and their grouped twins K16, K17, K18 run one kernel
//    body, masked_gemm_kernel, on the register-resident GEMM core
//    (gemm_core.cuh): a cp.async ring of (A, B, mask) slabs of 32,
//    mma.sync m16n8k16 for bf16 and 3xTF32 m16n8k8 for f32 (f32's digits
//    on the tensor cores), accumulators in registers, one rounding at the
//    store.  The forward (A = x, L = K, cols = N) stages w's rows as B
//    (gemm::MaskedRowsB); the dgrad (A = g, L = N, cols = K) stages the w
//    rows of dx's columns as they lie (gemm::MaskedColsB): w's contiguous
//    axis is the contraction, so the slab is already mma.sync's n-major B
//    operand, read by ldmatrix without .trans (f32: on 32-bit pairs), and
//    nothing is transposed.  Both apply the mask in place, in shared
//    memory, by the thread that copied the chunk.  The wgrad (A = x^T,
//    rows = K, L = Mp, cols = N) stages x's rows as they lie
//    (gemm::ColsA: ldmatrix.trans reads A) and g's rows as a dense B
//    (gemm::DenseRowsB), and multiplies the f32 sum by the mask at the
//    store (acc * float(m), as the reference's acc * m.astype(f32): an inf
//    or NaN sum under a zero mask gives NaN), from the tile's mask bytes
//    that the CTA copies into shared memory ahead of its walk (read at the
//    store they add a memory round trip after the walk: 0.95 against 0.52
//    ms at qwen2-moe's 16-row banks on an H100, PERF.md).  One CTA per
//    (BM-row tile, BN-column tile, group x split), the forward's and the
//    wgrad's grids
//    walking column tiles fastest, the dgrad's row tiles (the row tiles
//    that read one w tile run side by side: a bank's tile comes from HBM
//    about once).  The host plan (kernels/masked_matmul.py::fwd_plan, one
//    plan for the three directions on (rows, contraction, cols)) picks the
//    tile and splits the contraction into n_split whole-slab parts where
//    the grid alone would leave the SMs' resident slots empty (decode) or
//    its last wave mostly idle; a split stores f32 partials into a
//    workspace (n_split, G, rows, cols), unmasked for the wgrad, and
//    masked_merge_kernel (masked_dw_merge_kernel: then times the mask
//    byte) sums them in split order and rounds once.  K16, K17 and K18 are
//    K13, K14 and K15 with the bank's group in grid dim z (K13-K15 are the
//    bank of one).
//  * K19 and its grouped twin K20 still run on the tile layer
//    (tile_mma.cuh: wmma for bf16, full-precision FFMA for f32) and apply
//    the mask at the store: one CTA per (bk x bn) tile of m_new, looping
//    over all M rows in one CTA (the TPU kernel carried the sum across its
//    innermost grid axis); K20 is K19 with the bank's group as the grid's
//    third dimension.  A fully masked expert reads its zero mask like any
//    other: zero dx rows and a zero dw or m_new, no empty sum.
// K19/K20's epilogue (epilogue.cuh, shared with K7/K8) reads mom and w at
// the store; with sr it hashes the element's id gid = (g * K + row) * N +
// col (wrapping uint32; K and N are the padded extents the wrapper hands
// in) with the seed, as the reference's sr_to_bf16.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16, 495 TF32, 67 f32 FFMA):
// decode (16 padded rows) reads every weight and its mask byte once, far
// below the ridge: bytes bound it, and split-K keeps enough copies in
// flight.  The training shapes (M = 2048) do the dense work, 2 * M * K * N
// flops per call: in bf16 near the ridge; in f32 (the reference's MLP)
// 3xTF32 does three tensor-core products per f32 product.  The times
// against the bound are in PERF.md.
#include <algorithm>

#include "common.cuh"
#include "epilogue.cuh"
#include "gemm_launch.cuh"

namespace {

// K19 and K20: group g = blockIdx.z of x (G, Mp, K), g (G, Mp, N), wgm, w,
// mom and out (G, K, N); x, g and w in T, mom in TM, the new momentum in TO
// (w's type on the training path; f32 lets a check read the value before
// its rounding).
template <typename T, typename TM, typename TO>
__global__ void __launch_bounds__(tile::kThreads)
masked_dw_fused_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       const uint8_t* __restrict__ wgm, const T* __restrict__ w,
                       const TM* __restrict__ mom, TO* __restrict__ out, int Mp,
                       int K, int N, int bn, int bk, unsigned seed, float mu,
                       float wd, int sr) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* gs = xs + bk * (tile::kSlab + tile::pad<T>());
  float* scratch = reinterpret_cast<float*>(gs + tile::kSlab * (bn + tile::pad<T>()));
  const int n0 = blockIdx.x * bn, k0 = blockIdx.y * bk;
  const size_t grp = blockIdx.z, off = grp * K * N;

  tile::Acc<T> acc;
  tile::xtg(acc, xs, gs, x + grp * Mp * K, g + grp * Mp * N, Mp, K, N, k0, n0, bn, bk);
  acc.store(scratch, bk, bn, [&](int r, int c, float v) {
    const size_t i = off + (size_t)(k0 + r) * N + n0 + c;
    // (mu * mom + acc + wd * w) * m, each step rounded on its own
    float mn = __fmul_rn(epi::momentum(mu, mom[i], v, wd, w[i]),
                         static_cast<float>(wgm[i]));
    if (sr) mn = epi::sr_to_bf16(mn, seed, epi::element_id(grp, K, N, k0 + r, n0 + c));
    out[i] = tile::from_float<TO>(mn);
  });
}

template <typename T>
size_t smem_bytes(int rows, int cols) {
  return sizeof(T) * (rows * (tile::kSlab + tile::pad<T>()) +
                      tile::kSlab * (cols + tile::pad<T>())) +
         tile::epilogue_bytes<T>();
}

template <typename T, typename TM, typename TO>
int launch_fused(const void* x, const void* g, const void* wgm, const void* w,
                 const void* mom, void* out, int G, int Mp, int K, int N, int bn, int bk,
                 unsigned seed, float mu, float wd, int sr, void* stream) {
  const dim3 grid(N / bn, K / bk, G);
  masked_dw_fused_kernel<T, TM, TO><<<grid, tile::kThreads, smem_bytes<T>(bk, bn),
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const uint8_t*>(wgm), static_cast<const T*>(w),
      static_cast<const TM*>(mom), static_cast<TO*>(out), Mp, K, N, bn, bk, seed, mu,
      wd, sr);
  return static_cast<int>(cudaGetLastError());
}

// The wgrad's store reads the mask of its output tile: a CTA stages it
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
// N), b = w and m (G, cols = K, L)) and K15/K18 (DenseRowsB, ColsA: a = x
// (G, L = Mp, rows = K), b = g (G, L, cols = N), m (G, rows, cols)); out
// (G, rows, cols); blockIdx.z = group * n_split + s.  Split s walks L's
// slabs [s n / n_split, (s + 1) n / n_split) of n = ceil(L / 32) and, when
// n_split > 1, stores its f32 partial (for the wgrad unmasked) into part
// (n_split, G, rows, cols) in place of out.
template <class C>
__global__ void __launch_bounds__(C::kThreads, C::MIN_CTAS)
masked_gemm_kernel(const typename C::Type* __restrict__ a,
                   const typename C::Type* __restrict__ b, const uint8_t* __restrict__ m,
                   typename C::Type* __restrict__ out, float* __restrict__ part, int G,
                   int rows, int L, int cols, int n_split) {
  using T = typename C::Type;
  constexpr bool kMaskB = C::StageB::kMasked;  // else the mask multiplies the sum
  extern __shared__ __align__(128) unsigned char smem[];
  const int g = blockIdx.z / n_split, s = blockIdx.z % n_split;
  const int n_slabs = (L + gemm::kSlab - 1) / gemm::kSlab;
  const bool rows_fastest = C::StageB::kRowTilesFastest;
  const int m0 = (rows_fastest ? blockIdx.x : blockIdx.y) * C::BM;
  const int n0 = (rows_fastest ? blockIdx.y : blockIdx.x) * C::BN;
  const uint8_t* mg = m + (size_t)g * (kMaskB ? L : rows) * cols;
  unsigned char* tile_mask = smem + C::SMEM;  // the wgrad's (kTileMaskLd)
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
    T* og = out + (size_t)g * rows * cols;
    gemm::store(warp, rows, cols, m0, n0, [&](int r, int c, float v0, float v1) {
      const size_t i = (size_t)r * cols + c;
      if constexpr (kMaskB) {
        gemm::store2(og + i, v0, v1);
      } else {  // the pair's two mask bytes (c even), one rounding after
        const unsigned mb = *reinterpret_cast<const uint16_t*>(
            tile_mask + (r - m0) * kTileMaskLd<C> + c - n0);
        gemm::store2(og + i, v0 * static_cast<float>(mb & 0xffu),
                     v1 * static_cast<float>(mb >> 8));
      }
    });
  } else {
    float* pg = part + ((size_t)s * G + g) * rows * cols;
    gemm::store(warp, rows, cols, m0, n0, [&](int r, int c, float v0, float v1) {
      gemm::store2(pg + (size_t)r * cols + c, v0, v1);
    });
  }
}

// The split merge of K13, K14, K16 and K17: y[i] = sum over s of
// part[s][i], s = 0, 1, ... in order, rounded once to y's type; plane = G *
// rows * cols (a multiple of 4), n4 = plane / 4.
template <typename T>
__global__ void __launch_bounds__(256)
masked_merge_kernel(const float* __restrict__ part, T* __restrict__ y, size_t n4,
                    size_t plane, int n_split) {
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
    gemm::store4(y + 4 * i, v);
  }
}

// The split merge of K15 and K18: dw[i] = (sum over s of part[s][i], in
// order) * float(m[i]), rounded once to dw's type.  The partials are summed
// before the mask multiplies (an overflowed sum under a zero mask gives
// NaN, as in the unsplit kernel); m 4-byte aligned.
template <typename T>
__global__ void __launch_bounds__(256)
masked_dw_merge_kernel(const float* __restrict__ part, const uint8_t* __restrict__ m,
                       T* __restrict__ dw, size_t n4, size_t plane, int n_split) {
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
    const uchar4 mb = reinterpret_cast<const uchar4*>(m)[i];
    v.x *= static_cast<float>(mb.x);
    v.y *= static_cast<float>(mb.y);
    v.z *= static_cast<float>(mb.z);
    v.w *= static_cast<float>(mb.w);
    gemm::store4(dw + 4 * i, v);
  }
}

template <class C>
int launch_gemm(const void* a, const void* b, const void* m, void* out, void* part, int G,
                int rows, int L, int cols, int n_split, void* stream) {
  using T = typename C::Type;
  const auto kernel = masked_gemm_kernel<C>;
  cudaError_t err = gemm::prepare(kernel, smem_bytes_of<C>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned row_tiles = (rows + C::BM - 1) / C::BM, col_tiles = (cols + C::BN - 1) / C::BN;
  const dim3 grid(C::StageB::kRowTilesFastest ? row_tiles : col_tiles,
                  C::StageB::kRowTilesFastest ? col_tiles : row_tiles, G * n_split);
  kernel<<<grid, C::kThreads, smem_bytes_of<C>(), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const uint8_t*>(m),
      static_cast<T*>(out), static_cast<float*>(part), G, rows, L, cols, n_split);
  return static_cast<int>(cudaGetLastError());
}

inline int merge_blocks(size_t n4) {
  return static_cast<int>(std::min<size_t>((n4 + 255) / 256, 132 * 8));
}

template <typename T>
int launch_merge(const void* part, void* y, long long plane, int n_split, void* stream) {
  const size_t n4 = static_cast<size_t>(plane) / 4;
  masked_merge_kernel<T><<<merge_blocks(n4), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<T*>(y), n4, static_cast<size_t>(plane),
      n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dw_merge(const void* part, const void* m, void* dw, long long plane, int n_split,
                    void* stream) {
  const size_t n4 = static_cast<size_t>(plane) / 4;
  masked_dw_merge_kernel<T><<<merge_blocks(n4), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<const uint8_t*>(m), static_cast<T*>(dw), n4,
      static_cast<size_t>(plane), n_split);
  return static_cast<int>(cudaGetLastError());
}

// out: gemm::launch_info of configuration C.
template <class C>
int gemm_info(int* out) {
  return gemm::launch_info(masked_gemm_kernel<C>, smem_bytes_of<C>(), C::kThreads, out);
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
#define GEMM_ENTRIES(S, T)                                                           \
  extern "C" int masked_fwd_##S(const void* x, const void* w, const void* m,         \
                                void* y, void* part, int G, int Mp, int K, int N,    \
                                int bm, int bn, int n_split, void* stream) {         \
    return gemm::with_tile<T, gemm::MaskedRowsB>(bm, bn, [&](auto tag) {             \
      return launch_gemm<typename decltype(tag)::type>(x, w, m, y, part, G, Mp, K,   \
                                                       N, n_split, stream);          \
    });                                                                              \
  }                                                                                  \
  extern "C" int masked_dx_##S(const void* g, const void* w, const void* m,          \
                               void* dx, void* part, int G, int Mp, int K, int N,    \
                               int bm, int bn, int n_split, void* stream) {          \
    return gemm::with_tile<T, gemm::MaskedColsB>(bm, bn, [&](auto tag) {             \
      return launch_gemm<typename decltype(tag)::type>(g, w, m, dx, part, G, Mp, N,  \
                                                       K, n_split, stream);          \
    });                                                                              \
  }                                                                                  \
  extern "C" int masked_dw_##S(const void* x, const void* g, const void* m,          \
                               void* dw, void* part, int G, int Mp, int K, int N,    \
                               int bm, int bn, int n_split, void* stream) {          \
    return gemm::with_tile<T, gemm::DenseRowsB, gemm::ColsA>(bm, bn, [&](auto tag) { \
      return launch_gemm<typename decltype(tag)::type>(x, g, m, dw, part, G, K, Mp,  \
                                                       N, n_split, stream);          \
    });                                                                              \
  }                                                                                  \
  extern "C" int masked_merge_##S(const void* part, void* y, long long plane,        \
                                  int n_split, void* stream) {                       \
    return launch_merge<T>(part, y, plane, n_split, stream);                         \
  }                                                                                  \
  extern "C" int masked_dw_merge_##S(const void* part, const void* m, void* dw,      \
                                     long long plane, int n_split, void* stream) {   \
    return launch_dw_merge<T>(part, m, dw, plane, n_split, stream);                  \
  }                                                                                  \
  extern "C" int masked_fwd_info_##S(int bm, int bn, int* out) {                     \
    return gemm::with_tile<T, gemm::MaskedRowsB>(bm, bn, [&](auto tag) {             \
      return gemm_info<typename decltype(tag)::type>(out);                           \
    });                                                                              \
  }                                                                                  \
  extern "C" int masked_dx_info_##S(int bm, int bn, int* out) {                      \
    return gemm::with_tile<T, gemm::MaskedColsB>(bm, bn, [&](auto tag) {             \
      return gemm_info<typename decltype(tag)::type>(out);                           \
    });                                                                              \
  }                                                                                  \
  extern "C" int masked_dw_info_##S(int bm, int bn, int* out) {                      \
    return gemm::with_tile<T, gemm::DenseRowsB, gemm::ColsA>(bm, bn, [&](auto tag) { \
      return gemm_info<typename decltype(tag)::type>(out);                           \
    });                                                                              \
  }

GEMM_ENTRIES(bf16, __nv_bfloat16)
GEMM_ENTRIES(f32, float)

// K19: masked_dw_fused_<x/g/w type>_<mom type>_<output type>; K20:
// masked_dw_fused_grouped_<...>, every operand with a leading group dim.
#define FUSED_ENTRY(S, T, SM, TM, SO, TO)                                           \
  extern "C" int masked_dw_fused_##S##_##SM##_##SO(                                 \
      const void* x, const void* g, const void* wgm, const void* w,                 \
      const void* mom, void* out, int Mp, int K, int N, int bn, int bk,             \
      unsigned seed, float mu, float wd, int sr, void* stream) {                    \
    return launch_fused<T, TM, TO>(x, g, wgm, w, mom, out, 1, Mp, K, N, bn, bk,     \
                                   seed, mu, wd, sr, stream);                       \
  }                                                                                 \
  extern "C" int masked_dw_fused_grouped_##S##_##SM##_##SO(                         \
      const void* x, const void* g, const void* wgm, const void* w,                 \
      const void* mom, void* out, int G, int Mp, int K, int N, int bn, int bk,      \
      unsigned seed, float mu, float wd, int sr, void* stream) {                    \
    return launch_fused<T, TM, TO>(x, g, wgm, w, mom, out, G, Mp, K, N, bn, bk,     \
                                   seed, mu, wd, sr, stream);                       \
  }

FUSED_ENTRY(bf16, __nv_bfloat16, bf16, __nv_bfloat16, bf16, __nv_bfloat16)
FUSED_ENTRY(bf16, __nv_bfloat16, f32, float, bf16, __nv_bfloat16)
FUSED_ENTRY(bf16, __nv_bfloat16, bf16, __nv_bfloat16, f32, float)
FUSED_ENTRY(bf16, __nv_bfloat16, f32, float, f32, float)
FUSED_ENTRY(f32, float, bf16, __nv_bfloat16, f32, float)
FUSED_ENTRY(f32, float, f32, float, f32, float)
