// A CTA-level GEMM main loop on mma.sync with register-resident
// accumulators: the core of the masked forward (K13, and K16 with the
// bank's group as grid dim z), the masked dgrad (K14, and K17 likewise),
// the masked wgrad (K15, and K18 likewise) and its fused SGD epilogue (K19,
// and K20 likewise: masked_matmul.cu), the block-sparse wgrad (K3, and K6
// likewise) and its fused SGD epilogue (K7, and K8 likewise:
// block_sparse_bwd.cuh), the block-sparse forward (K1, and K4 likewise:
// block_sparse_fwd.cuh) and the block-sparse dgrad (K2, and K5 likewise:
// block_sparse_bwd.cuh).  How the sums become outputs (rounded, masked, the
// fused momentum) is an epilogue policy of each kernel (epilogue.cuh).
//
// A CTA owns one BM x BN tile of C = A @ B, A (rows x L), and walks the
// contraction dim L in slabs of kSlab = 32.  A slab map gives slab t's
// contraction offset and the end of its extent:
//  * DenseMap (every kernel but the block-sparse forward and dgrad): slab
//    t is L's slab s0 + t, its extent L; a split walks the slabs [s0, s1)
//    of L and the caller merges the parts.
//  * PackedMap (K1, K4, K2, K5): the contraction visits a packed list of
//    active blocks of bk contraction elements (K1/K4: K-blocks of a block
//    column's CSC list; K2/K5: N-blocks of a block row's CSR list, the
//    extent bn), the CTA's own list in shared memory: slab t (of the walk
//    from s0) is sub-slab (s0 + t) % spb of block ids[(s0 + t) / spb], spb
//    = ceil(bk / kSlab), and its extent ends where its block does, so a
//    slab of a block whose extent is not a multiple of 32 is zero-filled
//    past the block and never reads the next one.
// A is staged by one of two policies:
//  * RowsA (K13, K14, K16, K17, K1, K4, K2, K5): A (rows x L) row-major: a
//    slab is BM A rows of kSlab contraction elements.
//  * ColsA (K15, K18, K19, K20, K3, K6, K7, K8): A = x^T, x (L x rows) row-major: a
//    slab is kSlab x rows of BM elements each, staged as they lie (no
//    transpose through registers or scalar stores); ldmatrix.trans (bf16)
//    or scalar loads (f32) read the fragments.
// B by one of four:
//  * MaskedRowsB (K13, K16): B = w * m, w (L x cols) row-major: a slab is
//    kSlab w rows of BN columns.
//  * MaskedColsB (K14, K17): B = (w * m)^T, w (cols x L) row-major: a slab
//    is BN w rows of kSlab contraction elements, staged as they lie -- the
//    "n-major" B operand that mma.sync reads, so nothing is transposed.
//  * DenseColsB (K2, K5): B = w^T, w (cols x L) row-major, staged as
//    MaskedColsB stages it with no mask (the block-sparse dgrad's CSR list
//    decides which N-blocks of w's rows are read).
//  * DenseRowsB (K15, K18, K19, K20, K3, K6, K7, K8; K1, K4 with B = w): B = g (L x
//    cols) row-major, staged as MaskedRowsB stages w, with no mask (the
//    masked wgrads apply their mask at the store, outside this header; the
//    block-sparse forward's pack decides which rows of w are read).
// Rows, columns and L past their extents are zero-filled by the copies and
// never stored, so no extent has to be a multiple of a tile (cols, and
// ColsA's rows, must be multiples of 16: one 16-byte mask chunk, two bf16
// or four f32 copies; RowsA's and the n-major B's L likewise).  Each operand's
// row stride (lda, ldb) is an argument apart from the extents: the masked
// kernels pass their dense operands' own (the policies' dense_ld), the
// block-sparse wgrad walks one block of a wider x and g, the block's edges
// as the extents, the block-sparse forward one block column of w, its end
// the column extent, and the block-sparse dgrad one block row of w, its end
// the column extent.
//
//  * The ring.  STAGES stages in shared memory, each an A tile, a B tile
//    and, for a masked B, the B tile's mask (kSlab x BN bytes), filled by
//    16-byte cp.async.cg.  Slab t + STAGES - 1's copies are in flight while
//    the warps compute slab t; one __syncthreads a slab.
//  * The mask, applied in shared memory by the thread that copied it.  A
//    thread owns a 16-byte mask chunk (16 consecutive elements of one w
//    row) and the B chunks that hold the same 16 elements; after its
//    cp.async.wait_group it multiplies them in place (v * float(m): an inf
//    or NaN weight under a zero mask gives NaN, as the reference's w *
//    m.astype(w.dtype)), before the slab's one barrier.  No extra barrier,
//    no second copy.
//  * The warps, WM x WN over the CTA tile, each a (BM / WM) x (BN / WN)
//    warp tile of m16 x n8 accumulator fragments in registers for the
//    whole walk.  Shared rows are padded so that a warp's fragment loads
//    hit distinct banks: RowsA's rows, and MaskedColsB's B rows, by 16
//    bytes (kSlab + 16 / E elements: 80 bytes for bf16, 144 for f32, odd
//    multiples of 16, so the 8 row addresses of an ldmatrix fall in 8
//    distinct 16-byte bank groups); ColsA's and the row-major B's rows by 8
//    elements (bf16: an odd multiple of 16 bytes for ldmatrix.trans; f32: a
//    row stride of 8 banks, or 24 at 16 columns, mod 32, so the scalar
//    loads of one warp, rows t and columns g, cover the 32 banks once).
//  * bf16: mma.sync m16n8k16, A by ldmatrix (RowsA: m rows, k contiguous)
//    or ldmatrix.trans (ColsA: k rows, m contiguous), B by ldmatrix.trans
//    (MaskedRowsB, DenseRowsB: k rows, n contiguous) or by ldmatrix
//    (MaskedColsB, DenseColsB: n rows, k contiguous), f32 accumulation.
//  * f32: 3xTF32 on mma.sync m16n8k8.  Each operand v splits as hi =
//    cvt.rna.tf32(v), lo = cvt.rna.tf32(v - hi) (hi + lo carries ~22 of
//    f32's 24 bits), and the product is lo*hi + hi*lo + hi*hi (the lo*lo
//    term is below f32's rounding).  The tensor cores add with truncation,
//    so each slab's products go into zeroed registers first and are added
//    to the running sum with an IEEE f32 add (one rounding to nearest per
//    slab and element): the sum keeps f32's digits at any L.  An inf
//    operand splits into inf and a NaN low part (inf - inf), so every sum
//    it enters comes out NaN.  The kernel therefore checks its sums after
//    the walk (any NaN in the CTA, one __syncthreads_or) and walks a tile
//    that holds one again with the exact split (walk<C, true>): an inf
//    goes to lo with hi = 0, so it meets only the other operand's hi
//    (lo*hi): inf times a finite b gives inf with b's sign, times 0 NaN, as
//    the plain f32 product; only a product of two infs gives NaN where the
//    plain version has inf.  The exact split costs a compare and a select
//    a split, on every fragment, so only tiles with an inf or NaN input
//    pay it.  RowsA's A comes by ldmatrix on 32-bit pairs (an 8 x 8 b16
//    matrix is 8 rows of 4 floats; thread (g, t) receives row g, float t:
//    the tf32 A layout), and so does the n-major B's (row n = g, float k
//    = t: the tf32 B layout); ColsA's A and the row-major B's by scalar
//    ld.shared.
//  * The epilogue rounds the register fragments once and stores them with
//    bf16x2 or float2 stores (or stores f32 partials for a split).
//
// The order of every sum is fixed and there are no atomics: two launches
// on the same inputs give the same bits.

#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

#include "ptx.cuh"

namespace gemm {

constexpr int kSlab = 32;  // contraction elements of one ring stage

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// An A-stage policy says how many bytes its A tile takes (bytes), how a
// thread copies its part of a slab (load), and how a warp reads its A
// fragments (lane_base, frag16 for bf16, frag32 for f32).  In the fragment
// loads, af[i] = {a0, a1, a2, a3} of the warp's m16 block i (mma16816's A
// layout), and ah[i] the float bits of {(m = g, k = t), (g + 8, t), (g, t +
// 4), (g + 8, t + 4)} of block i (mma1688_tf32's).

// K13, K14, K16, K17, K1, K4: A (rows x L) row-major.  A stage holds the
// tile's BM A rows, each a run of kSlab contraction elements, padded by 16
// bytes.
struct RowsA {
  __host__ __device__ static constexpr int ld(int e) { return kSlab + 16 / e; }
  __host__ __device__ static constexpr int bytes(int bm, int e) { return bm * ld(e) * e; }
  // the row stride of a dense A (rows x L)
  __host__ __device__ static constexpr int dense_ld(int, int L) { return L; }

  // Start this thread's copies of A's slab l0: rows m0.. of a (rows x L,
  // row stride lda).
  template <class C>
  __device__ __forceinline__ static void load(uint32_t st, const typename C::Type* a, int lda,
                                              int rows, int L, int m0, int l0) {
    constexpr int per_row = kSlab / C::kPer, n = C::BM * per_row;
#pragma unroll
    for (int i = 0; i < (n + C::kThreads - 1) / C::kThreads; ++i) {
      const int c = threadIdx.x + i * C::kThreads;
      if (n % C::kThreads == 0 || c < n) {
        const int r = c / per_row, k = (c % per_row) * C::kPer;
        const bool ok = m0 + r < rows && l0 + k < L;
        ptx::cp_async16(st + (r * ld(C::E) + k) * C::E,
                        a + (ok ? (size_t)(m0 + r) * lda + l0 + k : 0), ok);
      }
    }
  }

  // bf16: ldmatrix rows lane % 16, column half lane / 16.  f32: ldmatrix x4
  // on f32 rows, matrices (rows 0-7 | 8-15) x (floats 0-3 | 4-7): lane's
  // row lane % 8 + 8 ((lane / 8) % 2), float column 4 (lane / 16).
  template <class C>
  __device__ __forceinline__ static uint32_t lane_base(uint32_t st, int wm) {
    const int lane = threadIdx.x & 31;
    if constexpr (C::E == 2)
      return st + 2 * ((wm * C::TM + (lane & 15)) * ld(C::E) + (lane >> 4) * 8);
    else
      return st + 4 * ((wm * C::TM + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld(C::E) +
                       (lane >> 4) * 4);
  }
  template <class C>
  __device__ __forceinline__ static void frag16(uint32_t (&af)[C::MT][4], uint32_t a, int kk) {
#pragma unroll
    for (int i = 0; i < C::MT; ++i) ptx::ldsm_x4(af[i], a + 2 * (i * 16 * ld(C::E) + kk * 16));
  }
  template <class C>
  __device__ __forceinline__ static void frag32(uint32_t (&ah)[C::MT][4], uint32_t a, int kk) {
#pragma unroll
    for (int i = 0; i < C::MT; ++i) ptx::ldsm_x4(ah[i], a + 4 * (i * 16 * ld(C::E) + kk * 8));
  }
};

// K15, K18: A = x^T, x (L x rows) row-major (the wgrad: L the token rows,
// rows dw's rows).  A stage holds kSlab x rows, each the tile's BM
// contiguous elements, as they lie, padded by 8 elements: the layout
// MaskedRowsB gives B, with m in place of n.
struct ColsA {
  __host__ __device__ static constexpr int ld(int bm) { return bm + 8; }
  __host__ __device__ static constexpr int bytes(int bm, int e) { return kSlab * ld(bm) * e; }
  // the row stride of a dense x (L x rows)
  __host__ __device__ static constexpr int dense_ld(int rows, int) { return rows; }

  // x's row stride lda; columns m0.. up to the extent rows
  template <class C>
  __device__ __forceinline__ static void load(uint32_t st, const typename C::Type* a, int lda,
                                              int rows, int L, int m0, int l0) {
    constexpr int per_row = C::BM / C::kPer, n = kSlab * per_row;
#pragma unroll
    for (int i = 0; i < (n + C::kThreads - 1) / C::kThreads; ++i) {
      const int c = threadIdx.x + i * C::kThreads;
      if (n % C::kThreads == 0 || c < n) {
        const int r = c / per_row, col = (c % per_row) * C::kPer;
        const bool ok = l0 + r < L && m0 + col < rows;
        ptx::cp_async16(st + (r * ld(C::BM) + col) * C::E,
                        a + (ok ? (size_t)(l0 + r) * lda + m0 + col : 0), ok);
      }
    }
  }

  // bf16: ldmatrix.trans rows k = lane % 8 + 8 (lane / 16), m half (lane /
  // 8) % 2, so the four matrices are a0 (m 0-7, k 0-7), a1 (m 8-15, k 0-7),
  // a2 (m 0-7, k 8-15), a3 (m 8-15, k 8-15); .trans hands thread (g, t) the
  // pair k = 2t, 2t + 1 at m = g.  f32: scalar loads of (k = t, m = g).
  template <class C>
  __device__ __forceinline__ static uint32_t lane_base(uint32_t st, int wm) {
    const int lane = threadIdx.x & 31;
    if constexpr (C::E == 2)
      return st + 2 * (((lane & 7) + ((lane >> 4) << 3)) * ld(C::BM) + wm * C::TM +
                       ((lane >> 3) & 1) * 8);
    else
      return st + 4 * ((lane & 3) * ld(C::BM) + wm * C::TM + (lane >> 2));
  }
  template <class C>
  __device__ __forceinline__ static void frag16(uint32_t (&af)[C::MT][4], uint32_t a, int kk) {
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
      ptx::ldsm_x4_t(af[i], a + 2 * (kk * 16 * ld(C::BM) + i * 16));
  }
  template <class C>
  __device__ __forceinline__ static void frag32(uint32_t (&ah)[C::MT][4], uint32_t a, int kk) {
    constexpr int k4 = 4 * 4 * ld(C::BM);  // bytes of 4 stage rows
#pragma unroll
    for (int i = 0; i < C::MT; ++i) {
      const uint32_t p = a + 4 * (kk * 8 * ld(C::BM) + i * 16);
      ah[i][0] = __float_as_uint(ptx::lds_f1(p));
      ah[i][1] = __float_as_uint(ptx::lds_f1(p + 4 * 8));
      ah[i][2] = __float_as_uint(ptx::lds_f1(p + k4));
      ah[i][3] = __float_as_uint(ptx::lds_f1(p + k4 + 4 * 8));
    }
  }
};

// A B-stage policy says whether it carries a mask (kMasked), where B's
// 16-element chunks (and the mask's) lie in B and in the stage (chunks,
// chunk, source), how many bytes its B tile and its mask take (bytes,
// mask_bytes), the order of the grid's CTAs (kRowTilesFastest), and how a
// warp reads its B fragments (lane_base, frag16 for bf16, frag32 for f32).
// In the fragment loads, bf[j] = {b0, b1} of the warp's n8 column block 2j,
// then {b0, b1} of block 2j + 1 (mma16816's B layout), and bv[j] = {(k = t,
// n = g), (k = t + 4, n = g)} of block j (mma1688_tf32's).

// K13/K16: B = w * m, w (L x cols) row-major and m its one-byte mask of the
// same shape.  A stage holds kSlab w rows of BN columns, padded by 8
// elements.  The grid walks the column tiles fastest: neighbouring CTAs
// share A's row tile.
struct MaskedRowsB {
  static constexpr bool kMasked = true, kRowTilesFastest = false;
  __host__ __device__ static constexpr int ld(int bn) { return bn + 8; }
  // the row stride of a dense w (L x cols)
  __host__ __device__ static constexpr int dense_ld(int, int cols) { return cols; }
  __host__ __device__ static constexpr int bytes(int bn, int e) { return kSlab * ld(bn) * e; }
  __host__ __device__ static constexpr int mask_bytes(int bn) { return kSlab * bn; }
  __host__ __device__ static constexpr int chunks(int bn) { return kSlab * bn / 16; }

  // Chunk c's byte offset in the stage's mask tile and its first element in
  // the stage's B tile.
  template <class C>
  __device__ __forceinline__ static void chunk(int c, int& ms, int& bs) {
    const int r = c / (C::BN / 16), col = (c % (C::BN / 16)) * 16;
    ms = r * C::BN + col;
    bs = r * ld(C::BN) + col;
  }
  // Chunk c's first element in w and m (row stride ld) for slab l0 of the
  // tile at column n0; false past an extent.
  template <class C>
  __device__ __forceinline__ static bool source(int c, int ld, int L, int cols, int n0, int l0,
                                                size_t& src) {
    const int r = c / (C::BN / 16), col = (c % (C::BN / 16)) * 16;
    const bool ok = l0 + r < L && n0 + col < cols;
    src = ok ? (size_t)(l0 + r) * ld + n0 + col : 0;
    return ok;
  }

  template <class C>
  __device__ __forceinline__ static uint32_t lane_base(uint32_t st, int wn) {
    const int lane = threadIdx.x & 31;
    // bf16: ldmatrix.trans rows, k lane % 8 + 8 ((lane / 8) % 2), column
    // half lane / 16; f32: scalar loads of (k = t, n = g)
    if constexpr (C::E == 2)
      return st + C::A_BYTES +
             2 * (((lane & 7) + (((lane >> 3) & 1) << 3)) * ld(C::BN) + wn * C::TN +
                  (lane >> 4) * 8);
    else
      return st + C::A_BYTES + 4 * ((lane & 3) * ld(C::BN) + wn * C::TN + (lane >> 2));
  }
  template <class C>
  __device__ __forceinline__ static void frag16(uint32_t (&bf)[C::NT / 2][4], uint32_t b,
                                                int kk) {
#pragma unroll
    for (int j = 0; j < C::NT / 2; ++j)
      ptx::ldsm_x4_t(bf[j], b + 2 * (kk * 16 * ld(C::BN) + j * 16));
  }
  template <class C>
  __device__ __forceinline__ static void frag32(float (&bv)[C::NT][2], uint32_t b, int kk) {
#pragma unroll
    for (int j = 0; j < C::NT; ++j) {
      bv[j][0] = ptx::lds_f1(b + 4 * (kk * 8 * ld(C::BN) + j * 8));
      bv[j][1] = ptx::lds_f1(b + 4 * ((kk * 8 + 4) * ld(C::BN) + j * 8));
    }
  }
};

// K14/K17: B = (w * m)^T, w (cols x L) row-major and m its one-byte mask of
// the same shape.  A stage holds the BN w rows of the tile's columns, each
// a run of kSlab contraction elements, as they lie in w (rows padded as A's)
// -- n-major, as mma.sync's B operand is read, so ldmatrix needs no .trans
// -- and their mask rows of kSlab bytes.  The grid walks the row tiles
// fastest: the CTAs that read one w tile run side by side, so a bank's
// tile and its mask come from HBM about once.
struct MaskedColsB {
  static constexpr bool kMasked = true, kRowTilesFastest = true;
  __host__ __device__ static constexpr int ld(int e) { return kSlab + 16 / e; }
  // the row stride of a dense w (cols x L)
  __host__ __device__ static constexpr int dense_ld(int L, int) { return L; }
  __host__ __device__ static constexpr int bytes(int bn, int e) { return bn * ld(e) * e; }
  __host__ __device__ static constexpr int mask_bytes(int bn) { return bn * kSlab; }
  __host__ __device__ static constexpr int chunks(int bn) { return bn * kSlab / 16; }

  template <class C>
  __device__ __forceinline__ static void chunk(int c, int& ms, int& bs) {
    const int r = c >> 1, k = (c & 1) * 16;
    ms = r * kSlab + k;
    bs = r * ld(C::E) + k;
  }
  template <class C>
  __device__ __forceinline__ static bool source(int c, int ld, int L, int cols, int n0, int l0,
                                                size_t& src) {
    const int r = c >> 1, k = (c & 1) * 16;
    const bool ok = n0 + r < cols && l0 + k < L;
    src = ok ? (size_t)(n0 + r) * ld + l0 + k : 0;
    return ok;
  }

  // ldmatrix rows: n lane % 8 + 8 (lane / 16), k half (lane / 8) % 2, so the
  // four matrices are (n 0-7 | 8-15) x (k low | high): b0 and b1 of two n8
  // blocks.  A k half is one 16-byte chunk: 8 bf16 (m16n8k16) or 4 floats
  // (an 8 x 8 b16 matrix is 8 rows of 4 floats: thread (g, t) receives (n =
  // g, k = t)).
  template <class C>
  __device__ __forceinline__ static uint32_t lane_base(uint32_t st, int wn) {
    const int lane = threadIdx.x & 31;
    const int row = wn * C::TN + (lane & 7) + ((lane >> 4) << 3);
    return st + C::A_BYTES + C::E * (row * ld(C::E) + ((lane >> 3) & 1) * C::kPer);
  }
  template <class C>
  __device__ __forceinline__ static void frag16(uint32_t (&bf)[C::NT / 2][4], uint32_t b,
                                                int kk) {
#pragma unroll
    for (int j = 0; j < C::NT / 2; ++j)
      ptx::ldsm_x4(bf[j], b + 2 * (j * 16 * ld(C::E) + kk * 16));
  }
  template <class C>
  __device__ __forceinline__ static void frag32(float (&bv)[C::NT][2], uint32_t b, int kk) {
#pragma unroll
    for (int j = 0; j < C::NT / 2; ++j) {
      uint32_t r[4];
      ptx::ldsm_x4(r, b + 4 * (j * 16 * ld(C::E) + kk * 8));
      bv[2 * j][0] = __uint_as_float(r[0]);
      bv[2 * j][1] = __uint_as_float(r[1]);
      bv[2 * j + 1][0] = __uint_as_float(r[2]);
      bv[2 * j + 1][1] = __uint_as_float(r[3]);
    }
  }
};

// K15/K18 and K3/K6: B = g (L x cols) row-major, staged as MaskedRowsB
// stages w (the same chunks, rows and fragments) with no mask chunk and no
// mask pass; K1/K4 stage w (L x cols) by it, the rows the pack names.  The masked wgrad's grid walks the column tiles fastest:
// neighbouring CTAs share A's tile, x's columns (row tiles fastest timed the
// same on an H100, PERF.md).
struct DenseRowsB : MaskedRowsB {
  static constexpr bool kMasked = false, kRowTilesFastest = false;
  __host__ __device__ static constexpr int mask_bytes(int) { return 0; }
};

// K2/K5: B = w^T, w (cols x L) row-major, staged as MaskedColsB stages it
// (the same rows, chunks and ldmatrix fragments, nothing transposed) with
// no mask chunk and no mask pass: a CTA stages the rows of w that its dx
// column tile reads, 32 contraction elements of one active N-block at a
// time.  The grid walks the row tiles fastest, as MaskedColsB's: the CTAs
// that read one block row of w run side by side.
struct DenseColsB : MaskedColsB {
  static constexpr bool kMasked = false, kRowTilesFastest = true;
  __host__ __device__ static constexpr int mask_bytes(int) { return 0; }
};

// One CTA configuration: element type T, CTA tile BM x BN, WM x WN warps,
// STAGES ring stages, at least MIN_CTAS resident per SM (the launch bound),
// B staged by the policy StageB, A by StageA.
template <typename T, int BM_, int BN_, int WM_, int WN_, int STAGES_, int MIN_CTAS_,
          class StageB_ = MaskedRowsB, class StageA_ = RowsA>
struct Cfg {
  using Type = T;
  using StageB = StageB_;
  using StageA = StageA_;
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_, MIN_CTAS = MIN_CTAS_;
  static constexpr int kWarps = WM * WN, kThreads = 32 * kWarps;
  static constexpr int TM = BM / WM, TN = BN / WN;  // warp tile
  static constexpr int MT = TM / 16, NT = TN / 8;   // m16 and n8 fragments a warp
  static constexpr int E = sizeof(T), kPer = 16 / E;  // elements a 16-byte chunk
  static constexpr int A_BYTES = StageA::bytes(BM, E), B_BYTES = StageB::bytes(BN, E),
                       M_BYTES = StageB::mask_bytes(BN);
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES + M_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES;
  static_assert(TM % 16 == 0 && TN % 16 == 0 && BN % 16 == 0, "fragment tiling");
  static_assert(STAGES >= 2, "a ring of at least two stages");
};

// Start this thread's copies of B's slab l0 and, for a masked B, its mask
// (the tile at column n0; row stride ldb, the mask's as B's) into the stage
// at shared-window address st.
template <class C>
__device__ __forceinline__ void load_b(uint32_t st, const typename C::Type* b,
                                       const uint8_t* m, int ldb, int L, int cols, int n0,
                                       int l0) {
  using P = typename C::StageB;
  constexpr int n = P::chunks(C::BN);
#pragma unroll
  for (int i = 0; i < (n + C::kThreads - 1) / C::kThreads; ++i) {
    const int c = threadIdx.x + i * C::kThreads;
    if (n % C::kThreads == 0 || c < n) {
      int ms, bs;
      size_t src;
      P::template chunk<C>(c, ms, bs);
      const bool ok = P::template source<C>(c, ldb, L, cols, n0, l0, src);
      if constexpr (P::kMasked) ptx::cp_async16(st + C::A_BYTES + C::B_BYTES + ms, m + src, ok);
#pragma unroll
      for (int j = 0; j < 16 / C::kPer; ++j)
        ptx::cp_async16(st + C::A_BYTES + (bs + j * C::kPer) * C::E, b + src + j * C::kPer, ok);
    }
  }
}

// After this thread's wait: multiply the B chunks it copied by their mask
// bytes, in place (stage: the stage's generic address).
template <class C>
__device__ __forceinline__ void mask_b(unsigned char* stage) {
  using T = typename C::Type;
  using P = typename C::StageB;
  constexpr int n = P::chunks(C::BN);
#pragma unroll
  for (int i = 0; i < (n + C::kThreads - 1) / C::kThreads; ++i) {
    const int c = threadIdx.x + i * C::kThreads;
    if (n % C::kThreads == 0 || c < n) {
      int ms, bs;
      P::template chunk<C>(c, ms, bs);
      const uint4 mv = *reinterpret_cast<const uint4*>(stage + C::A_BYTES + C::B_BYTES + ms);
      const uint8_t* mb = reinterpret_cast<const uint8_t*>(&mv);
      T* row = reinterpret_cast<T*>(stage + C::A_BYTES) + bs;
#pragma unroll
      for (int j = 0; j < 16 / C::kPer; ++j) {
        uint4 raw = *reinterpret_cast<const uint4*>(row + j * C::kPer);
        T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int e = 0; e < C::kPer; ++e)
          v[e] = from_float<T>(to_float(v[e]) * static_cast<float>(mb[j * C::kPer + e]));
        *reinterpret_cast<uint4*>(row + j * C::kPer) = raw;
      }
    }
  }
}

// The accumulators of one warp's tile and its per-slab products.
template <class C, typename T = typename C::Type>
struct Warp;

template <class C>
struct Warp<C, __nv_bfloat16> {
  float acc[C::MT][C::NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  }

  // One slab from the stage at st; (wm, wn): this warp's place in the CTA
  // (kExact: f32's exact split, nothing to bf16).
  template <bool kExact>
  __device__ __forceinline__ void slab(uint32_t st, int wm, int wn) {
    using P = typename C::StageB;
    using A = typename C::StageA;
    // the fragment layouts of mma.m16n8k16, A and B as the policies stage them
    const uint32_t a = A::template lane_base<C>(st, wm);
    const uint32_t b = P::template lane_base<C>(st, wn);
#pragma unroll
    for (int kk = 0; kk < kSlab / 16; ++kk) {
      uint32_t af[C::MT][4], bf[C::NT / 2][4];
      P::template frag16<C>(bf, b, kk);
      A::template frag16<C>(af, a, kk);
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NT / 2; ++j) {
          ptx::mma16816(acc[i][2 * j], af[i], bf[j][0], bf[j][1]);
          ptx::mma16816(acc[i][2 * j + 1], af[i], bf[j][2], bf[j][3]);
        }
    }
  }
};

// hi = tf32(v), lo = tf32(v - hi); with kExact an infinite v splits into
// hi = 0 and lo = v (the header says why).
template <bool kExact>
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = ptx::tf32_rna(v);
  if (kExact && isinf(__uint_as_float(hi))) hi = 0u;
  lo = ptx::tf32_rna(v - __uint_as_float(hi));
}

template <class C>
struct Warp<C, float> {
  float acc[C::MT][C::NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  }

  // Whether this thread's sums hold a NaN.
  __device__ __forceinline__ bool any_nan() const {
    bool nan = false;
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) nan |= isnan(acc[i][j][e]);
    return nan;
  }

  template <bool kExact>
  __device__ __forceinline__ void slab(uint32_t st, int wm, int wn) {
    using P = typename C::StageB;
    using A = typename C::StageA;
    // the tf32 fragment layouts, A and B as the policies stage them
    const uint32_t a = A::template lane_base<C>(st, wm);
    const uint32_t b = P::template lane_base<C>(st, wn);
    float part[C::MT][C::NT][4];
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kSlab / 8; ++kk) {
      float bv[C::NT][2];
      uint32_t ah[C::MT][4], al[C::MT][4], bh[C::NT][2], bl[C::NT][2];
      P::template frag32<C>(bv, b, kk);
      A::template frag32<C>(ah, a, kk);
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) split_tf32<kExact>(bv[j][e], bh[j][e], bl[j][e]);
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32<kExact>(__uint_as_float(ah[i][e]), ah[i][e], al[i][e]);
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NT; ++j) {
          ptx::mma1688_tf32(part[i][j], al[i], bh[j][0], bh[j][1]);
          ptx::mma1688_tf32(part[i][j], ah[i], bl[j][0], bl[j][1]);
          ptx::mma1688_tf32(part[i][j], ah[i], bh[j][0], bh[j][1]);
        }
    }
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = __fadd_rn(acc[i][j][e], part[i][j][e]);
  }
};

// Slab maps (the header says which kernel takes which): map(t, l0, end)
// sets slab t's first contraction element l0 and the end of its extent.
struct DenseMap {
  int s0, L;
  __device__ __forceinline__ void operator()(int t, int& l0, int& end) const {
    l0 = (s0 + t) * kSlab;
    end = L;
  }
};

struct PackedMap {
  const int* ids;   // the CTA's active blocks, in shared memory
  int bk, spb, s0;  // a block's contraction extent, slabs a block (ceil(bk / kSlab)), first slab
  __device__ __forceinline__ void operator()(int t, int& l0, int& end) const {
    const int u = s0 + t, k0 = ids[u / spb] * bk;
    l0 = k0 + (u % spb) * kSlab;
    end = k0 + bk;
  }
};

// The CTA's walk over the n slabs that ``map`` gives: A (as C::StageA lays
// it out, row stride lda) tile rows m0.., B and its mask (as C::StageB lays
// them out, row stride ldb; m unread for a dense B) tile columns n0..,
// rows and cols the extents; warp w owns warp tile (w / WN, w % WN).
// smem: C::SMEM bytes of dynamic shared memory.  kExact: f32's exact split.
template <class C, bool kExact = false, class Map>
__device__ __forceinline__ void walk_map(Warp<C>& warp, const typename C::Type* a, int lda,
                                         const typename C::Type* b, int ldb, const uint8_t* m,
                                         int rows, int cols, const Map& map, int m0, int n0,
                                         int n, unsigned char* smem) {
  using A = typename C::StageA;
  const uint32_t base = ptx::smem_addr(smem);
  const int w = threadIdx.x >> 5, wm = w / C::WN, wn = w % C::WN;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < n) {
      int l0, end;
      map(s, l0, end);
      A::template load<C>(base + s * C::STAGE_BYTES, a, lda, rows, end, m0, l0);
      load_b<C>(base + s * C::STAGE_BYTES, b, m, ldb, end, cols, n0, l0);
    }
    ptx::cp_async_commit();  // empty groups keep the count uniform
  }
  for (int t = 0; t < n; ++t) {
    ptx::cp_async_wait<C::STAGES - 2>();  // this thread's copies of slab t landed
    const int st = t % C::STAGES;
    if constexpr (C::StageB::kMasked) mask_b<C>(smem + st * C::STAGE_BYTES);
    __syncthreads();  // slab t complete in every thread; slab t - 1 consumed
    const int nx = t + C::STAGES - 1;
    if (nx < n) {
      const uint32_t dst = base + (nx % C::STAGES) * C::STAGE_BYTES;
      int l0, end;
      map(nx, l0, end);
      A::template load<C>(dst, a, lda, rows, end, m0, l0);
      load_b<C>(dst, b, m, ldb, end, cols, n0, l0);
    }
    ptx::cp_async_commit();
    warp.template slab<kExact>(base + st * C::STAGE_BYTES, wm, wn);
  }
  ptx::cp_async_wait_all();
}

// The dense walk over slabs [s0, s1) of L (L the contraction's extent).
template <class C, bool kExact = false>
__device__ __forceinline__ void walk(Warp<C>& warp, const typename C::Type* a, int lda,
                                     const typename C::Type* b, int ldb, const uint8_t* m,
                                     int rows, int cols, int L, int m0, int n0, int s0, int s1,
                                     unsigned char* smem) {
  walk_map<C, kExact>(warp, a, lda, b, ldb, m, rows, cols, DenseMap{s0, L}, m0, n0, s1 - s0,
                      smem);
}

// st(row, col, v0, v1) for this thread's fragment pairs (col even; v1 at
// col + 1) inside rows x cols, the CTA tile at (m0, n0); v0 and v1 are the
// accumulators themselves where st takes them by reference (K19/K20 fold
// the momentum into them before their store).
template <class C, class Store>
__device__ __forceinline__ void store(Warp<C>& warp, int rows, int cols, int m0, int n0,
                                      Store st) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = m0 + (w / C::WN) * C::TM + g, c0 = n0 + (w % C::WN) * C::TN + 2 * t;
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j) {
      const int r = r0 + i * 16, c = c0 + j * 8;
      if (c < cols) {
        if (r < rows) st(r, c, warp.acc[i][j][0], warp.acc[i][j][1]);
        if (r + 8 < rows) st(r + 8, c, warp.acc[i][j][2], warp.acc[i][j][3]);
      }
    }
}

}  // namespace gemm
