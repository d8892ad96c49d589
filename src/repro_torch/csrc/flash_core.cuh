// The warp-level core of the flash kernels: the online-softmax tile step
// (WarpRows) shared by the flash forward (K9, flash_fwd.cu) and the
// paged-prefix flash (K12, flash_paged.cu), and the backward's tile steps
// (WarpDq for K10, WarpDkv for K11, flash_bwd.cu; described where they are
// defined) on the same fragments, ldmatrix operands and cp.async ring.
//
// One warp owns 16 query rows and walks key tiles of up to KEYS keys
// (kTileKeys = 64, or 32 at d = 256, where a 64-key ring would leave room
// for one CTA an SM) that the CTA stages in shared memory.  Per tile:
//
//  * S = Q K^T by mma.sync m16n8k16 (bf16 in, f32 accumulate), operands
//    loaded by ldmatrix: Q's 16 x 16 A tiles from the CTA's Q rows, K's B
//    tiles from the key rows as they lie (a key row is a column of K^T).
//    S stays in the accumulator registers: KEYS / 8 n8 tiles (32 floats a
//    thread at 64 keys).
//  * Scale (with log2(e) folded in, so exp is one ex2), the optional softcap
//    c * tanh(s / c) and the mask apply to the fragments in place; the mask
//    only where the caller says the tile needs one.  Masked scores are
//    -inf; a row with no live key so far keeps m = -inf and p = 0.
//  * Row max and row sum: a thread holds 2 rows (g, g + 8) of the quad's
//    16; the max is reduced over the quad with __shfl_xor_sync (1, 2) every
//    tile, the sum l stays per thread (in f32, of the unrounded p) and is
//    reduced once, at the finish.
//  * p is rounded to bf16 and repacked straight into the A fragments of
//    O += P V: the m16n8 accumulator layout of two adjacent n8 tiles is the
//    m16k16 A layout.  V's B tiles come from ldmatrix.trans on the key rows,
//    so V needs no transposed copy.
//  * O stays in registers for the whole walk (D / 8 n8 tiles: 10 at d = 80,
//    16 at d = 128, 32 at d = 256), rescaled by exp(m_old - m_new) per row.
//
// S, P and O never touch shared memory; only the finish writes o and lse
// (or, for a split key walk, the unnormalised partial o, m and l).  The
// accumulation order is fixed and there are no atomics: two launches on
// the same inputs give the same bits.
//
// Shared-memory rows are padded to D + 8 elements: (D + 8) * 2 bytes is an
// odd multiple of 16 for every D that is a multiple of 16, so the 8 row
// addresses of one ldmatrix fall in 8 distinct 16-byte bank groups.
//
// The CTA stages K/V tiles in a ring of two stages filled by cp.async.cg
// 16-byte copies (key_walk below): tile t + 1's copies are in flight while
// the warps compute tile t, with one __syncthreads a tile.
//
// D is a template parameter (the fragment loops unroll); EXACT = false is
// the generic instantiation at D = 128 whose loops stop at the runtime d (a
// multiple of 16 up to 128).  d = 256 has exact instantiations only.
#pragma once
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "ptx.cuh"

namespace flash {

constexpr int kTileKeys = 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kEps = 1e-30f;

template <int D>
__host__ __device__ constexpr int row_pad() { return D + 8; }

// Shared bytes of `rows` padded rows.
template <int D>
__host__ __device__ constexpr int tile_bytes(int rows) {
  return rows * row_pad<D>() * 2;
}

// The PTX wrappers (ptx.cuh), shared with the GEMM core.
using ptx::cp_async16;
using ptx::cp_async_commit;
using ptx::cp_async_wait_all;
using ptx::ldsm_x4;
using ptx::ldsm_x4_t;
using ptx::lds_f1;
using ptx::lds_f2;
using ptx::mma16816;
using ptx::pack_bf16;
using ptx::smem_addr;

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Score transform: x = s * scale (then c * tanh(x / c)), in log2 units.
struct Scores {
  float scale_log2;  // scale * log2(e), without a softcap
  float inner;       // scale / c
  float cap_log2;    // c * log2(e); 0 = no softcap
  __device__ Scores(float scale, float softcap)
      : scale_log2(scale * kLog2e),
        inner(softcap != 0.0f ? scale / softcap : 0.0f),
        cap_log2(softcap * kLog2e) {}
  __device__ __forceinline__ float operator()(float s) const {
    return cap_log2 != 0.0f ? cap_log2 * tanhf(s * inner) : s * scale_log2;
  }
};

// The register state of one warp's 16 query rows: thread (g, t) = (lane / 4,
// lane % 4) holds rows g and g + 8, columns 8 n + 2 t and 8 n + 2 t + 1 of
// each n8 tile n.
template <int D, bool EXACT>
struct WarpRows {
  static constexpr int kN8 = D / 8;
  static constexpr int kDP = row_pad<D>();
  float o[kN8][4];
  float m[2];  // running max, log2 units; -inf while the row saw no live key
  float l[2];  // this thread's share of the row sum

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < kN8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.0f;
  }

  // One key tile of up to KEYS keys.  q_s: the warp's first Q row in shared
  // memory; k_s, v_s: the stage's first key row (shared-window addresses,
  // rows of kDP elements).  n16: the tile's 16-key groups (1..KEYS / 16;
  // the rows past them are never read and their columns never live).
  // keep(r, c): is key column c (0..KEYS - 1) visible to warp row r
  // (0..15); called only when need_mask.
  template <int KEYS = kTileKeys, typename Keep>
  __device__ __forceinline__ void attend(uint32_t q_s, uint32_t k_s, uint32_t v_s, int d,
                                         int n16, const Scores& sc, bool need_mask,
                                         Keep keep) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int d16 = EXACT ? D / 16 : d / 16;
    // ldmatrix row addresses of this lane (see the fragment layouts of
    // mma.m16n8k16): A rows lane % 16, column half lane / 16; K rows
    // lane % 8 + 8 (lane / 16), column half (lane / 8) % 2; V (trans) key
    // rows lane % 8 + 8 ((lane / 8) % 2), column half lane / 16.
    const uint32_t qa = q_s + 2 * ((lane & 15) * kDP + (lane >> 4) * 8);
    const uint32_t ka = k_s + 2 * (((lane & 7) + ((lane >> 4) << 3)) * kDP +
                                   ((lane >> 3) & 1) * 8);
    const uint32_t va = v_s + 2 * (((lane & 7) + (((lane >> 3) & 1) << 3)) * kDP +
                                   (lane >> 4) * 8);

    constexpr int kJ = KEYS / 8;  // the tile's n8 score tiles
    float s[kJ][4];
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < D / 16; ++kt) {
      if (EXACT || kt < d16) {
        uint32_t a[4];
        ldsm_x4(a, qa + kt * 32);
#pragma unroll
        for (int jj = 0; jj < kJ / 2; ++jj) {
          if (jj < n16) {
            uint32_t b[4];
            ldsm_x4(b, ka + jj * 16 * kDP * 2 + kt * 32);
            mma16816(s[2 * jj], a, b[0], b[1]);
            mma16816(s[2 * jj + 1], a, b[2], b[3]);
          }
        }
      }
    }

    // scale, softcap, mask (columns past the n16 groups are never live);
    // row max over the quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const bool past = j >= 2 * n16;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc(s[j][e]);
        if (past || (need_mask && !keep(g + (e >> 1) * 8, 8 * j + 2 * t + (e & 1))))
          x = -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float base[2], corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      base[h] = m_new == -INFINITY ? 0.0f : m_new;  // a row with no live key: p = 0
      corr[h] = exp2f(m[h] - base[h]);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int n = 0; n < kN8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
    // p = exp(s - m), summed in f32 and rounded to bf16 at once (as the TPU
    // kernel does before p @ v) into the A fragments of P: half the
    // registers S took
    uint32_t pa[kJ / 2][4];
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s[j][e] - base[e >> 1]);
        l[e >> 1] += p[e];
      }
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < kJ / 2; ++kk) {
      if (kk < n16) {
        const uint32_t (&a)[4] = pa[kk];
#pragma unroll
        for (int n = 0; n < D / 16; ++n) {
          if (EXACT || n < d16) {
            uint32_t b[4];
            ldsm_x4_t(b, va + kk * 16 * kDP * 2 + n * 32);
            mma16816(o[2 * n], a, b[0], b[1]);
            mma16816(o[2 * n + 1], a, b[2], b[3]);
          }
        }
      }
    }
  }

  // o = acc / max(l, 1e-30) in bf16 and lse = l > 0 ? m + log(l) : empty, in
  // natural units, for the warp rows r < valid; o_g / lse_g point at the
  // warp's row 0 (row stride d).
  __device__ __forceinline__ void store(__nv_bfloat16* o_g, float* lse_g, int d, int valid,
                                        float empty) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      const float lr = quad_sum(l[h]);
      if (r >= valid) continue;
      const float den = fmaxf(lr, kEps);
      __nv_bfloat16* orow = o_g + (size_t)r * d;
#pragma unroll
      for (int n = 0; n < kN8; ++n)
        if (EXACT || n < d / 8)
          *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t) =
              pack_bf16(o[n][2 * h] / den, o[n][2 * h + 1] / den);
      if (t == 0) lse_g[r] = lr > 0.0f ? m[h] * kLn2 + logf(den) : empty;
    }
  }

  // A split's partial: the unnormalised f32 acc (row stride d), m in natural
  // units (-1e30 where l = 0) and l.
  __device__ __forceinline__ void store_partial(float* o_g, float* m_g, float* l_g, int d,
                                                int valid) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      const float lr = quad_sum(l[h]);
      if (r >= valid) continue;
      float* orow = o_g + (size_t)r * d;
#pragma unroll
      for (int n = 0; n < kN8; ++n)
        if (EXACT || n < d / 8)
          *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) =
              make_float2(o[n][2 * h], o[n][2 * h + 1]);
      if (t == 0) {
        m_g[r] = lr > 0.0f ? m[h] * kLn2 : -1e30f;
        l_g[r] = lr;
      }
    }
  }
};

// ------------------------------------------------------------------ backward
//
// The tile steps of the flash backward (K10 and K11, flash_bwd.cu) on the
// same mma.sync core.  p is recomputed from the forward's logsumexp, p =
// exp(s' - lse) with s' the scaled (and capped) score, and ds = p (dp -
// delta) scale, times 1 - t^2 under a softcap (t = tanh(s scale / c)).
// The exponent is taken in log2 units, s scale log2(e) - lse log2(e), so p
// is one ex2.  A dead query row carries lse = +1e30, so its p is exactly 0;
// a masked slot gets p = 0 by select, never exp of a sentinel.

// p and ds of one score slot from the raw q.k (or k.q) s and do.v dp;
// lse2 = lse * log2(e).
struct BwdScores {
  float scale;       // 1 / sqrt(d)
  float scale_log2;  // scale * log2(e), without a softcap
  float inner;       // scale / c
  float cap_log2;    // c * log2(e); 0 = no softcap
  __device__ BwdScores(float scale_, float softcap)
      : scale(scale_),
        scale_log2(scale_ * kLog2e),
        inner(softcap != 0.0f ? scale_ / softcap : 0.0f),
        cap_log2(softcap * kLog2e) {}
  __device__ __forceinline__ void operator()(float s, float dp, float lse2, float delta,
                                             bool live, float& p, float& ds) const {
    if (cap_log2 != 0.0f) {
      const float t = tanhf(s * inner);
      p = live ? exp2f(t * cap_log2 - lse2) : 0.0f;
      ds = p * (dp - delta) * scale * (1.0f - t * t);
    } else {
      p = live ? exp2f(fmaf(s, scale_log2, -lse2)) : 0.0f;
      ds = p * (dp - delta) * scale;
    }
  }
  // The same in two halves for a warp that has s but not dp (WarpDkvPair):
  // p, and w = p (1 - t^2) under a softcap, else p; then ds from w.
  __device__ __forceinline__ void p_part(float s, float lse2, bool live, float& p,
                                         float& w) const {
    if (cap_log2 != 0.0f) {
      const float t = tanhf(s * inner);
      p = live ? exp2f(t * cap_log2 - lse2) : 0.0f;
      w = p * (1.0f - t * t);
    } else {
      p = live ? exp2f(fmaf(s, scale_log2, -lse2)) : 0.0f;
      w = p;
    }
  }
  __device__ __forceinline__ float ds_part(float w, float dp, float delta) const {
    return w * (dp - delta) * scale;
  }
};

// ldmatrix lane offsets (bytes) into 16-row operand tiles of kDP-element
// rows: an A tile (rows lane % 16, column half lane / 16), a B tile read as
// stored rows = n (rows lane % 8 + 8 (lane / 16), column half (lane / 8) % 2;
// each stored row is a column of B), and a B tile read transposed (stored
// rows = k: rows lane % 8 + 8 ((lane / 8) % 2), column half lane / 16).
template <int kDP>
__device__ __forceinline__ uint32_t off_a(int lane) {
  return 2 * ((lane & 15) * kDP + (lane >> 4) * 8);
}
template <int kDP>
__device__ __forceinline__ uint32_t off_b(int lane) {
  return 2 * (((lane & 7) + ((lane >> 4) << 3)) * kDP + ((lane >> 3) & 1) * 8);
}
template <int kDP>
__device__ __forceinline__ uint32_t off_bt(int lane) {
  return 2 * (((lane & 7) + (((lane >> 3) & 1) << 3)) * kDP + (lane >> 4) * 8);
}

// acc (16 x 16 as two n8 tiles) += A (16 x d, rows at a) @ B, where the 16
// stored rows at b + 16 grp rows are B's columns, over d.
template <int D, bool EXACT>
__device__ __forceinline__ void rows_dot(float (&acc)[2][4], uint32_t a, uint32_t b, int d16,
                                         int grp) {
  constexpr int kDP = row_pad<D>();
#pragma unroll
  for (int kt = 0; kt < D / 16; ++kt) {
    if (EXACT || kt < d16) {
      uint32_t af[4], bf[4];
      ldsm_x4(af, a + kt * 32);
      ldsm_x4(bf, b + grp * 16 * kDP * 2 + kt * 32);
      mma16816(acc[0], af, bf[0], bf[1]);
      mma16816(acc[1], af, bf[2], bf[3]);
    }
  }
}

// out (16 x d) += A (16 x 16, from registers) @ B, where B's 16 rows (the
// k index) are the stored rows at b + 16 grp rows, read by ldmatrix.trans.
template <int D, bool EXACT>
__device__ __forceinline__ void acc_product(float (&out)[D / 8][4], const uint32_t (&a)[4],
                                            uint32_t b, int d16, int grp) {
  constexpr int kDP = row_pad<D>();
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    if (EXACT || n < d16) {
      uint32_t bf[4];
      ldsm_x4_t(bf, b + grp * 16 * kDP * 2 + n * 32);
      mma16816(out[2 * n], a, bf[0], bf[1]);
      mma16816(out[2 * n + 1], a, bf[2], bf[3]);
    }
  }
}

// Round a warp's 16 x d f32 accumulator to bf16 rows (row stride d) for
// the warp rows r < valid, or store it unrounded (a split's partial).
template <int D, bool EXACT>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], __nv_bfloat16* out,
                                           int d, int valid) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h;
    if (r >= valid) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      if (EXACT || n < d / 8)
        *reinterpret_cast<uint32_t*>(out + (size_t)r * d + 8 * n + 2 * t) =
            pack_bf16(acc[n][2 * h], acc[n][2 * h + 1]);
  }
}
template <int D, bool EXACT>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float* out, int d,
                                           int valid) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h;
    if (r >= valid) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      if (EXACT || n < d / 8)
        *reinterpret_cast<float2*>(out + (size_t)r * d + 8 * n + 2 * t) =
            make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

// K10's register state: one warp's 16 query rows and their dq (16 x d).
// Per key tile of up to KEYS keys (64, or 32 at d = 256), one 16-key group
// at a time (so S and dP take 16 floats a thread, and the step fits 128
// registers at d = 80): S = Q K^T and dP =
// dO V^T in accumulators (K and V B tiles by ldmatrix from the key rows as
// they lie), p and ds in place, ds rounded to bf16 and repacked into A
// fragments (the accumulator-to-A repack of WarpRows::attend), then dq +=
// dS K with K's B tiles by ldmatrix.trans.  Only the tile's 16-key groups
// g_lo..g_hi - 1 that are live for the warp's rows run (a group wholly
// masked for them, as past the diagonal, is skipped: its p is 0).
template <int D, bool EXACT>
struct WarpDq {
  static constexpr int kN8 = D / 8;
  static constexpr int kDP = row_pad<D>();
  float dq[kN8][4];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < kN8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[n][e] = 0.0f;
  }

  // q_s, do_s: the warp's first Q and dO rows; k_s, v_s: the tile's first
  // key rows (shared-window addresses).  lse2, dlt: the thread's rows g and
  // g + 8.  keep(r, c): is key c (0..KEYS - 1) visible to warp row r;
  // called only when need_mask.
  template <int KEYS = kTileKeys, typename Keep>
  __device__ __forceinline__ void step(uint32_t q_s, uint32_t do_s, uint32_t k_s, uint32_t v_s,
                                       int d, int g_lo, int g_hi, const float (&lse2)[2],
                                       const float (&dlt)[2], const BwdScores& sc,
                                       bool need_mask, Keep keep) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int d16 = EXACT ? D / 16 : d / 16;
#pragma unroll
    for (int grp = 0; grp < KEYS / 16; ++grp) {
      if (grp < g_lo || grp >= g_hi) continue;
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
      rows_dot<D, EXACT>(s, q_s + off_a<kDP>(lane), k_s + off_b<kDP>(lane), d16, grp);
      rows_dot<D, EXACT>(dp, do_s + off_a<kDP>(lane), v_s + off_b<kDP>(lane), d16, grp);
      uint32_t dsa[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float p, ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live =
              !need_mask || keep(g + (e >> 1) * 8, 16 * grp + 8 * j + 2 * t + (e & 1));
          sc(s[j][e], dp[j][e], lse2[e >> 1], dlt[e >> 1], live, p, ds[e]);
        }
        dsa[j * 2] = pack_bf16(ds[0], ds[1]);
        dsa[j * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      acc_product<D, EXACT>(dq, dsa, k_s + off_bt<kDP>(lane), d16, grp);
    }
  }
};

// K11's register state: one warp's 16 KV rows and their dk and dv (16 x d
// each; 2 d / 4 floats a thread).  Per 64-row q tile, one 16-row q group
// at a time (so S^T and dP^T take 16 floats a thread): S^T = K Q^T and
// dP^T = V dO^T in accumulators (Q and dO B tiles by ldmatrix from the q
// rows as they lie), lse and delta taken per column, p^T and ds^T rounded
// to bf16 and repacked into A fragments, then dv += P^T dO and dk += dS^T Q
// with dO's and Q's B tiles by ldmatrix.trans.  Only the q groups
// g_lo..g_hi - 1 that are live for the warp's keys run.
template <int D, bool EXACT>
struct WarpDkv {
  static constexpr int kN8 = D / 8;
  static constexpr int kDP = row_pad<D>();
  float dk[kN8][4], dv[kN8][4];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < kN8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;
  }

  // k_s, v_s: the warp's first K and V rows; q_s, do_s: the tile's first q
  // rows; lse_s, dlt_s: the tile's lse and delta (natural units), all
  // shared-window addresses.  keep(r, c): is q row c (0..63) visible to
  // warp key r; called only when need_mask.
  template <typename Keep>
  __device__ __forceinline__ void step(uint32_t k_s, uint32_t v_s, uint32_t q_s, uint32_t do_s,
                                       uint32_t lse_s, uint32_t dlt_s, int d, int g_lo,
                                       int g_hi, const BwdScores& sc, bool need_mask,
                                       Keep keep) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int d16 = EXACT ? D / 16 : d / 16;
#pragma unroll
    for (int grp = 0; grp < 4; ++grp) {
      if (grp < g_lo || grp >= g_hi) continue;
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
      rows_dot<D, EXACT>(s, k_s + off_a<kDP>(lane), q_s + off_b<kDP>(lane), d16, grp);
      rows_dot<D, EXACT>(dp, v_s + off_a<kDP>(lane), do_s + off_b<kDP>(lane), d16, grp);
      uint32_t pa[4], dsa[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = 16 * grp + 8 * j + 2 * t;
        const float2 l = lds_f2(lse_s + 4 * c), dl = lds_f2(dlt_s + 4 * c);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = !need_mask || keep(g + (e >> 1) * 8, c + (e & 1));
          sc(s[j][e], dp[j][e], ((e & 1) ? l.y : l.x) * kLog2e, (e & 1) ? dl.y : dl.x, live,
             p[e], ds[e]);
        }
        pa[j * 2] = pack_bf16(p[0], p[1]);
        pa[j * 2 + 1] = pack_bf16(p[2], p[3]);
        dsa[j * 2] = pack_bf16(ds[0], ds[1]);
        dsa[j * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      acc_product<D, EXACT>(dv, pa, do_s + off_bt<kDP>(lane), d16, grp);
      acc_product<D, EXACT>(dk, dsa, q_s + off_bt<kDP>(lane), d16, grp);
    }
  }
};

// Named barriers of a warp pair (64 threads; ids 1..15, 0 is __syncthreads):
// arrive does not wait, sync waits for the pair.  Shared-memory writes
// before the arrive are visible to the pair after its sync.
__device__ __forceinline__ void pair_arrive(int id) {
  asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// K11's register state at d = 256, where dk and dv of 16 KV rows (2 d / 4
// = 128 floats a thread) do not both fit one warp's 255 registers: a pair
// of warps owns the 16 rows, the even warp (role 0) their dv and the odd
// one (role 1) their dk, 128 floats each.  Per 64-row q tile (16-row
// groups g_lo..g_hi - 1 live), role 0 computes S^T = K Q^T, p^T from lse
// and w = p (1 - t^2) (p under no softcap), stores w to the pair's buffer
// in shared memory, arrives at the pair's barrier and runs dv += P^T dO;
// role 1 computes dP^T = V dO^T meanwhile, waits at the barrier, reads w
// and runs ds = w (dp - delta) scale, dk += dS^T Q.  Each of K11's four
// products runs once, two in each warp, so the pair does the work one warp
// does at d <= 128.  The buffer takes 4 groups x 8 x 32 floats (4 KB), a
// thread's 8 values of a group at stride 32 words (no bank conflict); the
// CTA's __syncthreads between tiles keeps role 0's next writes after role
// 1's reads.
template <int D>
struct WarpDkvPair {
  static constexpr int kN8 = D / 8;
  static constexpr int kDP = row_pad<D>();
  static constexpr int kBufBytes = 4 * 8 * 32 * 4;  // a pair's buffer
  float acc[kN8][4];  // dv (role 0) or dk (role 1)

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < kN8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }

  // As WarpDkv::step; role 0 or 1, bar: the pair's barrier id, buf: its
  // buffer (shared-window address).
  template <typename Keep>
  __device__ __forceinline__ void step(int role, int bar, uint32_t buf, uint32_t k_s,
                                       uint32_t v_s, uint32_t q_s, uint32_t do_s,
                                       uint32_t lse_s, uint32_t dlt_s, int g_lo, int g_hi,
                                       const BwdScores& sc, bool need_mask, Keep keep) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    constexpr int d16 = D / 16;
    const uint32_t mine = buf + 4 * lane;
    if (role == 0) {
      uint32_t pa[4][4];
#pragma unroll
      for (int grp = 0; grp < 4; ++grp) {
        if (grp < g_lo || grp >= g_hi) continue;
        float s[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
        rows_dot<D, true>(s, k_s + off_a<kDP>(lane), q_s + off_b<kDP>(lane), d16, grp);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = 16 * grp + 8 * j + 2 * t;
          const float2 l = lds_f2(lse_s + 4 * c);
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool live = !need_mask || keep(g + (e >> 1) * 8, c + (e & 1));
            float w;
            sc.p_part(s[j][e], ((e & 1) ? l.y : l.x) * kLog2e, live, p[e], w);
            asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(
                             mine + 4 * 32 * (8 * grp + 4 * j + e)),
                         "f"(w)
                         : "memory");
          }
          pa[grp][j * 2] = pack_bf16(p[0], p[1]);
          pa[grp][j * 2 + 1] = pack_bf16(p[2], p[3]);
        }
      }
      pair_arrive(bar);
#pragma unroll
      for (int grp = 0; grp < 4; ++grp)
        if (grp >= g_lo && grp < g_hi)
          acc_product<D, true>(acc, pa[grp], do_s + off_bt<kDP>(lane), d16, grp);
    } else {
      float dp[4][2][4];
#pragma unroll
      for (int grp = 0; grp < 4; ++grp) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[grp][j][e] = 0.0f;
        if (grp >= g_lo && grp < g_hi)
          rows_dot<D, true>(dp[grp], v_s + off_a<kDP>(lane), do_s + off_b<kDP>(lane), d16,
                            grp);
      }
      pair_sync(bar);
#pragma unroll
      for (int grp = 0; grp < 4; ++grp) {
        if (grp < g_lo || grp >= g_hi) continue;
        uint32_t dsa[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = 16 * grp + 8 * j + 2 * t;
          const float2 dl = lds_f2(dlt_s + 4 * c);
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ds[e] = sc.ds_part(lds_f1(mine + 4 * 32 * (8 * grp + 4 * j + e)), dp[grp][j][e],
                               (e & 1) ? dl.y : dl.x);
          dsa[j * 2] = pack_bf16(ds[0], ds[1]);
          dsa[j * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
        acc_product<D, true>(acc, dsa, q_s + off_bt<kDP>(lane), d16, grp);
      }
    }
  }
};

// The live 16-row groups [lo, hi) of a tile's n16 groups for a warp, when
// group i is dead iff dead(i) and the dead groups lie at the ends.
template <typename Dead>
__device__ __forceinline__ void live_groups(int n16, Dead dead, int& lo, int& hi) {
  lo = 0;
  while (lo < n16 && dead(lo)) ++lo;
  hi = n16;
  while (hi > lo && dead(hi - 1)) --hi;
}

// The CTA's key walk over n_tiles tiles through a two-stage K/V ring.
// issue(t, stage) starts tile t's cp.async copies into the stage (every
// thread); compute(t, stage) runs after the tile has landed and is visible
// to every warp; after(t) runs once compute(t) is done (K12 stores the
// table rows it prefetched there).  The caller committed its prologue
// copies (Q, and tile 0 via issue(0, 0)) as one group.  One __syncthreads
// a tile: it makes tile t visible and tells every thread that the stage
// tile t + 1 goes to (tile t - 1's) is no longer read.
template <typename Issue, typename Compute, typename After>
__device__ __forceinline__ void key_walk(int n_tiles, Issue issue, Compute compute,
                                         After after) {
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < n_tiles) issue(t + 1, (t + 1) & 1);
    cp_async_commit();
    compute(t, t & 1);
    after(t);
  }
  cp_async_wait_all();  // a walk of no tile still has the prologue's copies
}

}  // namespace flash
