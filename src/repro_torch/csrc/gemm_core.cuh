// A CTA-level GEMM main loop on mma.sync with register-resident
// accumulators: the core of the masked forward (K13, and K16 with the
// bank's group as grid dim z), built so that the other matmul kernels can
// move onto it one by one.
//
// A CTA owns one BM x BN tile of C = A @ B, A (rows x L, row-major) and B
// (L x cols, row-major), and walks the contraction dim L in slabs of
// kSlab = 32 from slab s0 to slab s1 (a split walks a part of L; the
// caller merges the parts).  Rows, columns and L past their extents are
// zero-filled by the copies and never stored, so no extent has to be a
// multiple of a tile (cols and L must be multiples of 16: one 16-byte
// mask chunk, two bf16 or four f32 copies).
//
//  * The ring.  STAGES stages in shared memory, each an A tile (BM x kSlab),
//    a B tile (kSlab x BN) and the B tile's mask (kSlab x BN bytes), filled
//    by 16-byte cp.async.cg.  Slab t + STAGES - 1's copies are in flight
//    while the warps compute slab t; one __syncthreads a slab.
//  * The mask, applied in shared memory by the thread that copied it.  A
//    thread owns a 16-byte mask chunk (16 columns of one row) and the B
//    chunks that hold the same 16 elements; after its cp.async.wait_group
//    it multiplies them in place (v * float(m): an inf or NaN weight under a
//    zero mask gives NaN, as the reference's w * m.astype(w.dtype)), before
//    the slab's one barrier.  No extra barrier, no second copy.
//  * The warps, WM x WN over the CTA tile, each a (BM / WM) x (BN / WN)
//    warp tile of m16 x n8 accumulator fragments in registers for the
//    whole walk.  Shared rows are padded so that a warp's fragment loads
//    hit distinct banks: A rows by kSlab + 16 bytes (80 bytes for bf16,
//    144 for f32: odd multiples of 16, so the 8 row addresses of an
//    ldmatrix fall in 8 distinct 16-byte bank groups); B rows by 8
//    elements (bf16: an odd multiple of 16 bytes for ldmatrix.trans; f32:
//    a row stride of 8 banks mod 32, so the scalar B loads of one warp,
//    rows t and columns g, cover the 32 banks once).
//  * bf16: mma.sync m16n8k16, A by ldmatrix, B (k rows, n contiguous) by
//    ldmatrix.trans, f32 accumulation.
//  * f32: 3xTF32 on mma.sync m16n8k8.  Each operand v splits as hi =
//    cvt.rna.tf32(v), lo = cvt.rna.tf32(v - hi) (hi + lo carries ~22 of
//    f32's 24 bits), and the product is lo*hi + hi*lo + hi*hi (the lo*lo
//    term is below f32's rounding).  The tensor cores add with truncation,
//    so each slab's products go into zeroed registers first and are added
//    to the running sum with an IEEE f32 add (one rounding to nearest per
//    slab and element): the sum keeps f32's digits at any L.  A comes by
//    ldmatrix on 32-bit pairs (an 8 x 8 b16 matrix is 8 rows of 4 floats;
//    thread (g, t) receives row g, float t: the tf32 A layout), B by scalar
//    ld.shared.
//  * The epilogue rounds the register fragments once and stores them with
//    bf16x2 or float2 stores (or stores f32 partials for a split).
//
// The order of every sum is fixed and there are no atomics: two launches
// on the same inputs give the same bits.
//
// What the later matmul kernels need and this header does not build yet:
// a transposed-B stage (B = (w * m)^T, K14 and K17) and a walk over the
// rows M with a dense B (x^T @ g: K15, K18, K19, K20).  Both are another
// stage_b policy beside MaskedRowsB and another A staging.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

#include "ptx.cuh"

namespace gemm {

constexpr int kSlab = 32;  // contraction elements of one ring stage

// One CTA configuration: element type T, CTA tile BM x BN, WM x WN warps,
// STAGES ring stages, at least MIN_CTAS resident per SM (the launch bound).
template <typename T, int BM_, int BN_, int WM_, int WN_, int STAGES_, int MIN_CTAS_>
struct Cfg {
  using Type = T;
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_, MIN_CTAS = MIN_CTAS_;
  static constexpr int kWarps = WM * WN, kThreads = 32 * kWarps;
  static constexpr int TM = BM / WM, TN = BN / WN;  // warp tile
  static constexpr int MT = TM / 16, NT = TN / 8;   // m16 and n8 fragments a warp
  static constexpr int E = sizeof(T), kPer = 16 / E;  // elements a 16-byte chunk
  static constexpr int ALD = kSlab + kPer, BLD = BN + 8;  // padded rows, in elements
  static constexpr int A_BYTES = BM * ALD * E, B_BYTES = kSlab * BLD * E,
                       M_BYTES = kSlab * BN;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES + M_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES;
  static_assert(TM % 16 == 0 && TN % 16 == 0 && BN % 16 == 0, "fragment tiling");
  static_assert(STAGES >= 2, "a ring of at least two stages");
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The B stage of K13/K16: B = w * m, w (L x cols) row-major and m its
// one-byte mask of the same shape.
struct MaskedRowsB {
  template <class C>
  __host__ __device__ static constexpr int chunks() { return kSlab * C::BN / 16; }  // mask chunks

  // Start this thread's copies of slab l0 (B and mask) into the stage at
  // shared-window address st.
  template <class C>
  __device__ __forceinline__ static void load(uint32_t st, const typename C::Type* b,
                                              const uint8_t* m, int L, int cols, int n0,
                                              int l0) {
    constexpr int per_row = C::BN / 16, n = chunks<C>();
#pragma unroll
    for (int i = 0; i < (n + C::kThreads - 1) / C::kThreads; ++i) {
      const int c = threadIdx.x + i * C::kThreads;
      if (n % C::kThreads == 0 || c < n) {
        const int r = c / per_row, col = (c % per_row) * 16;
        const bool ok = l0 + r < L && n0 + col < cols;
        const size_t off = ok ? (size_t)(l0 + r) * cols + n0 + col : 0;
        ptx::cp_async16(st + C::A_BYTES + C::B_BYTES + r * C::BN + col, m + off, ok);
#pragma unroll
        for (int j = 0; j < 16 / C::kPer; ++j)
          ptx::cp_async16(st + C::A_BYTES + (r * C::BLD + col + j * C::kPer) * C::E,
                          b + off + j * C::kPer, ok);
      }
    }
  }

  // After this thread's wait: multiply the B chunks it copied by their mask
  // bytes, in place (stage: the stage's generic address).
  template <class C>
  __device__ __forceinline__ static void finish(unsigned char* stage) {
    using T = typename C::Type;
    constexpr int per_row = C::BN / 16, n = chunks<C>();
#pragma unroll
    for (int i = 0; i < (n + C::kThreads - 1) / C::kThreads; ++i) {
      const int c = threadIdx.x + i * C::kThreads;
      if (n % C::kThreads == 0 || c < n) {
        const int r = c / per_row, col = (c % per_row) * 16;
        const uint4 mv =
            *reinterpret_cast<const uint4*>(stage + C::A_BYTES + C::B_BYTES + r * C::BN + col);
        const uint8_t* mb = reinterpret_cast<const uint8_t*>(&mv);
        T* row = reinterpret_cast<T*>(stage + C::A_BYTES) + r * C::BLD + col;
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
};

// Start this thread's copies of A's slab l0: rows m0.. of a (rows x L).
template <class C>
__device__ __forceinline__ void load_a(uint32_t st, const typename C::Type* a, int rows,
                                       int L, int m0, int l0) {
  constexpr int per_row = kSlab / C::kPer, n = C::BM * per_row;
#pragma unroll
  for (int i = 0; i < (n + C::kThreads - 1) / C::kThreads; ++i) {
    const int c = threadIdx.x + i * C::kThreads;
    if (n % C::kThreads == 0 || c < n) {
      const int r = c / per_row, k = (c % per_row) * C::kPer;
      const bool ok = m0 + r < rows && l0 + k < L;
      ptx::cp_async16(st + (r * C::ALD + k) * C::E,
                      a + (ok ? (size_t)(m0 + r) * L + l0 + k : 0), ok);
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

  // One slab from the stage at st; (wm, wn): this warp's place in the CTA.
  __device__ __forceinline__ void slab(uint32_t st, int wm, int wn) {
    const int lane = threadIdx.x & 31;
    // ldmatrix row addresses (the fragment layouts of mma.m16n8k16): A rows
    // lane % 16, column half lane / 16; B (trans) k rows lane % 8 + 8
    // ((lane / 8) % 2), column half lane / 16
    const uint32_t a = st + 2 * ((wm * C::TM + (lane & 15)) * C::ALD + (lane >> 4) * 8);
    const uint32_t b = st + C::A_BYTES +
                       2 * (((lane & 7) + (((lane >> 3) & 1) << 3)) * C::BLD + wn * C::TN +
                            (lane >> 4) * 8);
#pragma unroll
    for (int kk = 0; kk < kSlab / 16; ++kk) {
      uint32_t af[C::MT][4], bf[C::NT / 2][4];
#pragma unroll
      for (int j = 0; j < C::NT / 2; ++j)
        ptx::ldsm_x4_t(bf[j], b + 2 * (kk * 16 * C::BLD + j * 16));
#pragma unroll
      for (int i = 0; i < C::MT; ++i) ptx::ldsm_x4(af[i], a + 2 * (i * 16 * C::ALD + kk * 16));
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

// hi = tf32(v), lo = tf32(v - hi).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = ptx::tf32_rna(v);
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

  __device__ __forceinline__ void slab(uint32_t st, int wm, int wn) {
    const int lane = threadIdx.x & 31;
    // A: ldmatrix x4 on f32 rows, matrices (rows 0-7 | 8-15) x (floats 0-3 |
    // 4-7): lane's row lane % 8 + 8 ((lane / 8) % 2), float column 4 (lane /
    // 16).  B: scalar loads of (k = t, n = g) and (t + 4, g).
    const uint32_t a = st + 4 * ((wm * C::TM + (lane & 7) + (((lane >> 3) & 1) << 3)) * C::ALD +
                                 (lane >> 4) * 4);
    const uint32_t b = st + C::A_BYTES + 4 * ((lane & 3) * C::BLD + wn * C::TN + (lane >> 2));
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
#pragma unroll
      for (int j = 0; j < C::NT; ++j) {
        bv[j][0] = ptx::lds_f1(b + 4 * (kk * 8 * C::BLD + j * 8));
        bv[j][1] = ptx::lds_f1(b + 4 * ((kk * 8 + 4) * C::BLD + j * 8));
      }
#pragma unroll
      for (int i = 0; i < C::MT; ++i) ptx::ldsm_x4(ah[i], a + 4 * (i * 16 * C::ALD + kk * 8));
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) split_tf32(bv[j][e], bh[j][e], bl[j][e]);
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(ah[i][e]), ah[i][e], al[i][e]);
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

// The CTA's walk over slabs [s0, s1) of L: A (rows x L) tile rows m0..,
// B (L x cols) and its mask tile columns n0..; warp w owns warp tile (w /
// WN, w % WN).  smem: C::SMEM bytes of dynamic shared memory.
template <class C, class StageB>
__device__ __forceinline__ void walk(Warp<C>& warp, const typename C::Type* a,
                                     const typename C::Type* b, const uint8_t* m, int rows,
                                     int cols, int L, int m0, int n0, int s0, int s1,
                                     unsigned char* smem) {
  const uint32_t base = ptx::smem_addr(smem);
  const int n = s1 - s0, w = threadIdx.x >> 5, wm = w / C::WN, wn = w % C::WN;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < n) {
      load_a<C>(base + s * C::STAGE_BYTES, a, rows, L, m0, (s0 + s) * kSlab);
      StageB::template load<C>(base + s * C::STAGE_BYTES, b, m, L, cols, n0, (s0 + s) * kSlab);
    }
    ptx::cp_async_commit();  // empty groups keep the count uniform
  }
  for (int t = 0; t < n; ++t) {
    ptx::cp_async_wait<C::STAGES - 2>();  // this thread's copies of slab t landed
    const int st = t % C::STAGES;
    StageB::template finish<C>(smem + st * C::STAGE_BYTES);
    __syncthreads();  // slab t complete in every thread; slab t - 1 consumed
    const int nx = t + C::STAGES - 1;
    if (nx < n) {
      const uint32_t dst = base + (nx % C::STAGES) * C::STAGE_BYTES;
      load_a<C>(dst, a, rows, L, m0, (s0 + nx) * kSlab);
      StageB::template load<C>(dst, b, m, L, cols, n0, (s0 + nx) * kSlab);
    }
    ptx::cp_async_commit();
    warp.slab(base + st * C::STAGE_BYTES, wm, wn);
  }
  ptx::cp_async_wait_all();
}

// st(row, col, v0, v1) for this thread's fragment pairs (col even; v1 at
// col + 1) inside rows x cols, the CTA tile at (m0, n0).
template <class C, class Store>
__device__ __forceinline__ void store(const Warp<C>& warp, int rows, int cols, int m0, int n0,
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
