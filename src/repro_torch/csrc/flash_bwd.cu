// Flash-attention backward over a host-built AttnSchedule: dq (K10) and
// dk/dv (K11), recomputing p = exp(s - lse) from the forward's logsumexp.
//
// K10 replaces repro/kernels/flash_attention.py::_dq_kernel (pallas_call in
// _dq_call):  dq = sum over the live KV blocks kv_idx[qb, :kv_cnt[qb]] of
// ds @ k, with ds = p * (do @ v^T - delta) * scale (times 1 - t^2 under a
// softcap, t = tanh(u / c)).
// K11 replaces ::_dkv_kernel (pallas_call in _dkv_call):  for KV block kb,
// dv = sum p^T @ do and dk = sum ds^T @ q over the live q-blocks
// q_idx[kb, :q_cnt[kb]] (the transposed schedule) AND over the G query
// heads of its GQA group (q row b * G + gm reads KV row b).
//
// Rounding points as the reference's kernels: scores and do @ v^T in f32
// from bf16 operands, p rounded to do's type before p^T @ do, ds rounded to
// q's/k's type before ds @ k and ds^T @ q, f32 accumulators, each output
// rounded once.  Masked score slots (causal, window, padded keys kpos >= sk)
// get p = 0 (the reference's exp(NEG_INF - lse) = 0); a dead query row
// carries lse = +1e30 from the forward, so every p of it is 0, never NaN.
//
// Bound on the H100: per live (q, k) pair K10 does 6 d flops (three
// products) and K11 8 d (four) on the tensor cores; the bytes are q, k, v,
// do, lse, delta and the outputs once, so at training lengths the tensor
// cores bound both.
//
// Design, on the warp-level core of csrc/flash_core.cuh (mma.sync m16n8k16
// with ldmatrix operands, shared with K9 and K12): a CTA owns one unit of
// rows, each warp 16 of them, and keeps their gradient in registers for
// its whole walk; the scores, dP, p and ds never touch shared memory
// (WarpDq, WarpDkv).
//  * K10: a unit is the query rows of one (bh, q-block): 128 (8 warps) at
//    d = 64 and d = 80, 64 (4 warps, so a bq = 128 block is two units) at
//    d = 128 and in the generic instantiation.  Q and dO are staged once; the CTA
//    walks the live KV blocks as 64-key tiles through the two-stage
//    cp.async ring of K and V (key_walk), sharing each tile among its
//    warps.  dq stays in registers and is stored once.
//  * K11: a unit is 64 KV rows of one (B*KV row, KV block), so a bk = 128
//    block is two units (the rows of dk and dv are independent: no sum
//    crosses CTAs but a split's).  K and V are staged once; the ring
//    streams 64-row Q and dO tiles with their lse and delta over the G
//    group members and the live q-blocks of the transposed schedule.
//    lse and delta are read per column of the S^T accumulator.
//  * The walk lists only the live 64-row sub-tiles of the schedule's live
//    blocks: a sub-tile wholly dead for the unit (under causal, a K11
//    unit's half of a diagonal 128 x 128 block above the diagonal; keys
//    past sk) is skipped, and inside a tile a warp runs only its live
//    16-row groups (a K10 warp above the diagonal skips the whole tile).  The element
//    mask applies only where a warp's tile crosses the diagonal, the
//    window's edge or sk.  Warp 0 builds the list in shared memory with a
//    ballot, in schedule order.
//  * Balance, the causal critical path: under a causal mask the walks grow
//    linearly along the units, so a CTA may pair unit j with unit
//    n - 1 - j (pair = 1), walking both in turn; and each unit's walk may
//    be split over n_split CTAs (split s takes steps [s L / n_split,
//    (s + 1) L / n_split) of its L), each storing its f32 partial, which a
//    second kernel of this source sums in the fixed order s = 0..n_split -
//    1 and rounds once.  The wrapper's plan
//    (kernels/flash_attention.py::bwd_plan) picks (pair, n_split) per
//    launch by list-scheduling each candidate's CTAs on the card's
//    resident CTA slots.  No float atomics: two launches give the same
//    bits.
//  * d = 256 (gemma3): a 528-byte padded row and 128 accumulator floats a
//    thread for each of dq, dk and dv.  K10 runs 8 warps (a 128-row unit)
//    on 32-key tiles, one CTA an SM (Q and dO 135 KB, the ring 67.6 KB)
//    under a 255-register cap.  K11 cannot keep dk and dv of 16 KV rows in
//    one warp (256 floats a thread): warp pairs split them
//    (flash_core.cuh::WarpDkvPair, dv in the even warp and dk in the odd
//    one, p handed over through shared memory), 8 warps for a 64-row unit,
//    one CTA an SM (K and V 67.6 KB, the ring 135 KB, the pairs' buffers
//    16 KB).
// head_dim is a runtime multiple of 16 up to 128, or 256; d = 64, 80, 128
// and 256 run their own instantiations, other d the generic one.  Resident
// per SM: K10 2 CTAs (16 warps at d = 64 and d = 80 under a 128-register
// launch bound, 73.8 / 90.1 KB of shared memory; 8 at d = 128, 104.5 KB), K11
// 3 at d = 64 and d = 80 (161 / 168 registers, 56.4 / 68.7 KB) and 2 at
// d = 128 (105.5 KB); K10 and K11 1 at d = 256 (8 warps each); no spill.
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "flash_core.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::kTileKeys;

constexpr int kRows = 64;  // a K11 unit's KV rows
constexpr int kMergeThreads = 256;

// Warps of a K10 CTA: 8 (a 128-row unit) at d = 64 and d = 80, where the
// step fits 128 registers, so two CTAs (16 warps) are resident per SM, and
// at d = 256 (one CTA); 4 (64 rows) at d = 128 and in the generic
// instantiation, two CTAs by shared memory.
template <int D>
__host__ __device__ constexpr int dq_warps() { return D <= 80 || D > 128 ? 8 : 4; }

// K10's CTAs resident per SM (its launch bound's minimum): 1 at d = 256.
template <int D>
__host__ __device__ constexpr int dq_ctas() { return D > 128 ? 1 : 2; }

// Keys a K10 ring tile: 32 at d = 256, else 64.
template <int D>
__host__ __device__ constexpr int dq_keys() { return D > 128 ? 32 : kTileKeys; }

// K11 at d = 256 splits a warp's dk and dv over a warp pair.
template <int D>
__host__ __device__ constexpr bool dkv_pair() { return D > 128; }

// Warps of a K11 CTA (64 KV rows): 4, or 8 in pairs.
template <int D>
__host__ __device__ constexpr int dkv_warps() { return dkv_pair<D>() ? 8 : 4; }

// K11's CTAs resident per SM, by the launch bound (d = 64, d = 80) or
// shared memory.
template <int D>
__host__ __device__ constexpr int dkv_ctas() { return D <= 80 ? 3 : D > 128 ? 1 : 2; }

// The unit's own two operands (own_rows rows each), two ring stages of two
// `keys`-row operands, for K11 two stages of 64 lse and delta and the warp
// pairs' buffers, then the walk list's length and entries.
template <int D>
size_t smem_bytes(int own_rows, int keys, int list_max, bool dkv) {
  return (size_t)flash::tile_bytes<D>(2 * own_rows + 4 * keys) +
         (dkv ? sizeof(float) * 4 * kTileKeys : 0) +
         (dkv && dkv_pair<D>() ? (size_t)(dkv_warps<D>() / 2) *
                                     flash::WarpDkvPair<D>::kBufBytes
                               : 0) +
         sizeof(int) * (list_max + 1);
}

// Warp 0 compacts the live ones of n candidates into list (in candidate
// order): entry(i, val) says whether candidate i is live and sets its
// value.  Every thread gets the count.
template <typename Entry>
__device__ __forceinline__ int build_list(int n, int* list_n, int* list, Entry entry) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int count = 0;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      int val = 0;
      const bool live = i < n && entry(i, val);
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (live) list[count + __popc(m & ((1u << lane) - 1u))] = val;
      count += __popc(m);
    }
    if (lane == 0) *list_n = count;
  }
  __syncthreads();
  return *list_n;
}

// ---------------------------------------------------------------- K10: dq

template <int D, bool EXACT>
__global__ void __launch_bounds__(dq_warps<D>() * 32, dq_ctas<D>())
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ kv_idx, const int* __restrict__ kv_cnt,
                bf16* __restrict__ dq, float* __restrict__ part, int Sqp, int Skp, int d_rt,
                int bq, int bk, int width, int groups, int causal, int window, int q_offset,
                int sk, int pair, int n_split, float scale, float softcap) {
  constexpr int DP = flash::row_pad<D>();
  constexpr int KT = dq_keys<D>();
  constexpr int kStage = flash::tile_bytes<D>(KT);
  constexpr int kDqThreads = dq_warps<D>() * 32;
  constexpr int kDqRows = dq_warps<D>() * 16;  // the unit's query rows
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t qs = flash::smem_addr(smem);              // the unit's Q rows
  const uint32_t dos = qs + flash::tile_bytes<D>(kDqRows);   // and dO rows
  const uint32_t ks = dos + flash::tile_bytes<D>(kDqRows);   // 2 K stages
  const uint32_t vs = ks + 2 * kStage;                     // 2 V stages
  int* list_n =
      reinterpret_cast<int*>(smem + flash::tile_bytes<D>(2 * kDqRows + 4 * KT));
  int* list = list_n + 1;  // key0 of each live KT-key tile

  const int d = EXACT ? D : d_rt;
  const int cpr = d / 8;  // 16-byte chunks a row
  const int parts = (bq + kDqRows - 1) / kDqRows;
  const int n_units = (Sqp / bq) * parts;
  const int nsub = (bk + KT - 1) / KT;
  const int c = blockIdx.x / n_split, split = blockIdx.x % n_split;
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kv_row0 = (bh / groups) * Skp;  // KV row bh / G
  const flash::BwdScores sc(scale, softcap);
  const int mate = n_units - 1 - c;

  for (int i = 0; i < (pair && mate != c ? 2 : 1); ++i) {
    const int u = i == 0 ? c : mate;
    const int qb = u / parts, row0 = (u % parts) * kDqRows;
    const int rows = min(kDqRows, bq - row0);  // a multiple of 16
    const int q_row0 = bh * Sqp + qb * bq + row0;
    const int qpos0 = q_offset + qb * bq + row0;
    if (i > 0) __syncthreads();  // the first unit's walk is done with Q, dO and the list
    const int* walk = kv_idx + (size_t)qb * width;
    const int n_live = build_list(kv_cnt[qb] * nsub, list_n, list, [&](int e, int& key0) {
      const int sub = e % nsub;
      key0 = walk[e / nsub] * bk + sub * KT;
      const int k_hi = key0 + min(KT, bk - sub * KT) - 1;
      return !(key0 >= sk || (causal && key0 > qpos0 + rows - 1) ||
               (window && k_hi <= qpos0 - window));
    });
    const int t0 = (int)((long long)split * n_live / n_split);
    const int t1 = (int)((long long)(split + 1) * n_live / n_split);

    for (int x = threadIdx.x; x < kDqRows * cpr; x += kDqThreads) {
      const int r = x / cpr, col = (x % cpr) * 8;
      const bool ok = r < rows;
      const size_t g = (size_t)(q_row0 + (ok ? r : 0)) * d + col;
      flash::cp_async16(qs + 2 * (r * DP + col), q + g, ok);
      flash::cp_async16(dos + 2 * (r * DP + col), dout + g, ok);
    }
    auto issue = [&](int t, int stage) {
      const int key0 = list[t];
      const int nk = min(KT, bk - key0 % bk);
      for (int x = threadIdx.x; x < nk * cpr; x += kDqThreads) {
        const int r = x / cpr, col = (x % cpr) * 8;
        const size_t g = (size_t)(kv_row0 + key0 + r) * d + col;
        const uint32_t at = stage * kStage + 2 * (r * DP + col);
        flash::cp_async16(ks + at, k + g, true);
        flash::cp_async16(vs + at, v + g, true);
      }
    };
    if (t1 > t0) issue(t0, 0);
    flash::cp_async_commit();

    const bool live = warp * 16 < rows;
    const int q_lo = qpos0 + warp * 16;  // the warp's first position
    float lse2[2] = {0.0f, 0.0f}, dlt[2] = {0.0f, 0.0f};
    if (live) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = q_row0 + warp * 16 + (lane >> 2) + 8 * h;
        lse2[h] = lse[r] * flash::kLog2e;
        dlt[h] = delta[r];
      }
    }
    flash::WarpDq<D, EXACT> acc;
    acc.init();
    flash::key_walk(
        t1 - t0, [&](int t, int stage) { issue(t0 + t, stage); },
        [&](int t, int stage) {
          if (!live) return;
          const int key0 = list[t0 + t];
          int lo, hi;
          flash::live_groups(
              min(KT, bk - key0 % bk) / 16,
              [&](int j) {
                const int k0 = key0 + 16 * j;
                return k0 >= sk || (causal && k0 > q_lo + 15) ||
                       (window && k0 + 15 <= q_lo - window);
              },
              lo, hi);
          if (lo >= hi) return;
          const int k_lo = key0 + 16 * lo, k_hi = key0 + 16 * hi - 1;
          const bool inside = k_hi < sk && (!causal || k_hi <= q_lo) &&
                              (!window || k_lo > q_lo + 15 - window);
          acc.template step<KT>(qs + warp * 16 * DP * 2, dos + warp * 16 * DP * 2,
                   ks + stage * kStage,
                   vs + stage * kStage, d, lo, hi, lse2, dlt, sc, !inside,
                   [&](int r, int cc) {
                     const int kpos = key0 + cc, qpos = q_lo + r;
                     return kpos < sk && (!causal || kpos <= qpos) &&
                            (!window || kpos > qpos - window);
                   });
        },
        [](int) {});

    if (live) {
      const size_t at = (size_t)(q_row0 + warp * 16) * d;
      if (n_split == 1)
        flash::store_rows<D, EXACT>(acc.dq, dq + at, d, 16);
      else
        flash::store_rows<D, EXACT>(acc.dq, part + (size_t)split * gridDim.y * Sqp * d + at, d,
                                    16);
    }
  }
}

// ---------------------------------------------------------------- K11: dk, dv

template <int D, bool EXACT>
__global__ void __launch_bounds__(dkv_warps<D>() * 32, dkv_ctas<D>())
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ q_idx, const int* __restrict__ q_cnt,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ dk_part,
                 float* __restrict__ dv_part, int Sqp, int Skp, int d_rt, int bq, int bk,
                 int q_width, int groups, int causal, int window, int q_offset, int sk,
                 int pair, int n_split, float scale, float softcap) {
  constexpr int DP = flash::row_pad<D>();
  constexpr int kStage = flash::tile_bytes<D>(kTileKeys);
  constexpr bool kPair = dkv_pair<D>();
  constexpr int kThreads = dkv_warps<D>() * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t ks = flash::smem_addr(smem);             // the unit's K rows
  const uint32_t vs = ks + flash::tile_bytes<D>(kRows);   // and V rows
  const uint32_t qs = vs + flash::tile_bytes<D>(kRows);   // 2 Q stages
  const uint32_t dos = qs + 2 * kStage;                   // 2 dO stages
  float* lse_s = reinterpret_cast<float*>(smem + flash::tile_bytes<D>(2 * kRows + 4 * kTileKeys));
  float* dlt_s = lse_s + 2 * kTileKeys;  // 2 stages each
  // the warp pairs' buffers (d = 256), then the walk list
  const uint32_t pbuf = flash::smem_addr(dlt_s + 2 * kTileKeys);
  int* list_n = reinterpret_cast<int*>(
      dlt_s + 2 * kTileKeys +
      (kPair ? dkv_warps<D>() / 2 * flash::WarpDkvPair<D>::kBufBytes / 4 : 0));
  int* list = list_n + 1;  // first row of each live 64-row q tile
  const uint32_t lse_a = flash::smem_addr(lse_s), dlt_a = flash::smem_addr(dlt_s);

  const int d = EXACT ? D : d_rt;
  const int cpr = d / 8;
  const int parts = (bk + kRows - 1) / kRows;
  const int n_units = (Skp / bk) * parts;
  const int nsub = (bq + kTileKeys - 1) / kTileKeys;
  const int c = blockIdx.x / n_split, split = blockIdx.x % n_split;
  const int b = blockIdx.y;  // row of the (B*KV, Skp, d) layout
  // the warp's 16 KV rows: warp (a pair's two warps, role 0 and 1, under kPair)
  const int warp = kPair ? threadIdx.x / 64 : threadIdx.x / 32;
  const int role = kPair ? (threadIdx.x / 32) & 1 : 0;
  const flash::BwdScores sc(scale, softcap);
  const int mate = n_units - 1 - c;

  for (int i = 0; i < (pair && mate != c ? 2 : 1); ++i) {
    const int u = i == 0 ? c : mate;
    const int kb = u / parts;
    const int key0 = kb * bk + (u % parts) * kRows;
    const int nkeys = min(kRows, bk - (u % parts) * kRows);  // a multiple of 16
    const int kv_row0 = b * Skp + key0;
    if (i > 0) __syncthreads();  // the first unit's walk is done with K, V and the list
    const int* walk = q_idx + (size_t)kb * q_width;
    const int n_q = build_list(q_cnt[kb] * nsub, list_n, list, [&](int e, int& qrow0) {
      const int sub = e % nsub;
      qrow0 = walk[e / nsub] * bq + sub * kTileKeys;
      const int qp_lo = q_offset + qrow0;
      const int qp_hi = qp_lo + min(kTileKeys, bq - sub * kTileKeys) - 1;
      return !(key0 >= sk || (causal && key0 > qp_hi) ||
               (window && key0 + nkeys - 1 <= qp_lo - window));
    });
    const int n_steps = groups * n_q;  // member gm = step / n_q, tile list[step % n_q]
    const int t0 = (int)((long long)split * n_steps / n_split);
    const int t1 = (int)((long long)(split + 1) * n_steps / n_split);

    for (int x = threadIdx.x; x < kRows * cpr; x += kThreads) {
      const int r = x / cpr, col = (x % cpr) * 8;
      const bool ok = r < nkeys;
      const size_t g = (size_t)(kv_row0 + (ok ? r : 0)) * d + col;
      flash::cp_async16(ks + 2 * (r * DP + col), k + g, ok);
      flash::cp_async16(vs + 2 * (r * DP + col), v + g, ok);
    }
    auto issue = [&](int t, int stage) {
      const int qrow0 = list[t % n_q];
      const int nq = min(kTileKeys, bq - qrow0 % bq);
      const int row = (b * groups + t / n_q) * Sqp + qrow0;
      for (int x = threadIdx.x; x < nq * cpr; x += kThreads) {
        const int r = x / cpr, col = (x % cpr) * 8;
        const size_t g = (size_t)(row + r) * d + col;
        const uint32_t at = stage * kStage + 2 * (r * DP + col);
        flash::cp_async16(qs + at, q + g, true);
        flash::cp_async16(dos + at, dout + g, true);
      }
      for (int x = threadIdx.x; x < nq / 4; x += kThreads) {
        const uint32_t at = stage * kTileKeys * 4 + 16 * x;
        flash::cp_async16(lse_a + at, lse + row + 4 * x, true);
        flash::cp_async16(dlt_a + at, delta + row + 4 * x, true);
      }
    };
    if (t1 > t0) issue(t0, 0);
    flash::cp_async_commit();

    const bool live = warp * 16 < nkeys;
    const int kw_lo = key0 + warp * 16, kw_hi = kw_lo + 15;  // the warp's keys
    std::conditional_t<kPair, flash::WarpDkvPair<D>, flash::WarpDkv<D, EXACT>> acc;
    acc.init();
    flash::key_walk(
        t1 - t0, [&](int t, int stage) { issue(t0 + t, stage); },
        [&](int t, int stage) {
          if (!live) return;
          const int qrow0 = list[(t0 + t) % n_q];
          const int qp_lo = q_offset + qrow0;
          int lo, hi;
          flash::live_groups(
              min(kTileKeys, bq - qrow0 % bq) / 16,
              [&](int j) {
                const int q0 = qp_lo + 16 * j;
                return kw_lo >= sk || (causal && kw_lo > q0 + 15) ||
                       (window && kw_hi <= q0 - window);
              },
              lo, hi);
          if (lo >= hi) return;
          const int q_lo = qp_lo + 16 * lo, q_hi = qp_lo + 16 * hi - 1;
          const bool inside = kw_hi < sk && (!causal || kw_hi <= q_lo) &&
                              (!window || kw_lo > q_hi - window);
          auto keep = [&](int r, int cc) {
            const int kpos = kw_lo + r, qpos = qp_lo + cc;
            return kpos < sk && (!causal || kpos <= qpos) && (!window || kpos > qpos - window);
          };
          if constexpr (kPair)
            acc.step(role, 1 + warp, pbuf + warp * flash::WarpDkvPair<D>::kBufBytes,
                     ks + warp * 16 * DP * 2, vs + warp * 16 * DP * 2, qs + stage * kStage,
                     dos + stage * kStage, lse_a + stage * kTileKeys * 4,
                     dlt_a + stage * kTileKeys * 4, lo, hi, sc, !inside, keep);
          else
            acc.step(ks + warp * 16 * DP * 2, vs + warp * 16 * DP * 2, qs + stage * kStage,
                     dos + stage * kStage, lse_a + stage * kTileKeys * 4,
                     dlt_a + stage * kTileKeys * 4, d, lo, hi, sc, !inside, keep);
        },
        [](int) {});

    if (live) {
      const size_t at = (size_t)(kv_row0 + warp * 16) * d;
      const size_t ps = (size_t)split * gridDim.y * Skp * d;
      if constexpr (kPair) {  // role 0 holds dv, role 1 dk
        if (n_split == 1)
          flash::store_rows<D, EXACT>(acc.acc, (role ? dk : dv) + at, d, 16);
        else
          flash::store_rows<D, EXACT>(acc.acc, (role ? dk_part : dv_part) + ps + at, d, 16);
      } else if (n_split == 1) {
        flash::store_rows<D, EXACT>(acc.dk, dk + at, d, 16);
        flash::store_rows<D, EXACT>(acc.dv, dv + at, d, 16);
      } else {
        flash::store_rows<D, EXACT>(acc.dk, dk_part + ps + at, d, 16);
        flash::store_rows<D, EXACT>(acc.dv, dv_part + ps + at, d, 16);
      }
    }
  }
}

// out[i] = sum over s = 0..n_split-1 (in that order) of part[s * n + i],
// rounded to bf16 once; 4 elements a thread; grid.y picks (part0, out0) or
// (part1, out1).
__global__ void __launch_bounds__(kMergeThreads)
flash_bwd_merge_kernel(const float* __restrict__ part0, bf16* __restrict__ out0,
             const float* __restrict__ part1, bf16* __restrict__ out1, size_t n, int n_split) {
  const float* part = blockIdx.y ? part1 : part0;
  bf16* out = blockIdx.y ? out1 : out0;
  const size_t i = ((size_t)blockIdx.x * kMergeThreads + threadIdx.x) * 4;
  if (i >= n) return;
  float4 acc = *reinterpret_cast<const float4*>(part + i);
  for (int s = 1; s < n_split; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(part + (size_t)s * n + i);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  *reinterpret_cast<uint2*>(out + i) =
      make_uint2(flash::pack_bf16(acc.x, acc.y), flash::pack_bf16(acc.z, acc.w));
}

cudaError_t merge(const float* p0, bf16* o0, const float* p1, bf16* o1, size_t n, int n_split,
                  cudaStream_t stream) {
  const dim3 grid((unsigned)((n / 4 + kMergeThreads - 1) / kMergeThreads), p1 ? 2 : 1);
  flash_bwd_merge_kernel<<<grid, kMergeThreads, 0, stream>>>(p0, o0, p1, o1, n, n_split);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// CTAs along the unit axis: units pair up under `pair`.
int unit_ctas(int n_units, int pair) { return pair ? (n_units + 1) / 2 : n_units; }

template <int D, bool EXACT>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* kv_idx, const void* kv_cnt, void* dq, void* part,
              int BH, int Sqp, int Skp, int d, int bq, int bk, int width, int groups,
              int causal, int window, int q_offset, int sk, int pair, int n_split, float scale,
              float softcap, cudaStream_t stream) {
  constexpr int kDqRows = dq_warps<D>() * 16;
  constexpr int KT = dq_keys<D>();
  const size_t smem = smem_bytes<D>(kDqRows, KT, width * ((bk + KT - 1) / KT), false);
  cudaError_t err = prepare(flash_dq_kernel<D, EXACT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_units = (Sqp / bq) * ((bq + kDqRows - 1) / kDqRows);
  const dim3 grid(unit_ctas(n_units, pair) * n_split, BH);
  flash_dq_kernel<D, EXACT><<<grid, dq_warps<D>() * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(kv_idx),
      static_cast<const int*>(kv_cnt), static_cast<bf16*>(dq), static_cast<float*>(part), Sqp,
      Skp, d, bq, bk, width, groups, causal, window, q_offset, sk, pair, n_split, scale,
      softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  return static_cast<int>(merge(static_cast<const float*>(part), static_cast<bf16*>(dq),
                                nullptr, nullptr, (size_t)BH * Sqp * d, n_split, stream));
}

template <int D, bool EXACT>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* q_idx, const void* q_cnt, void* dk, void* dv,
               void* dk_part, void* dv_part, int BH, int Sqp, int Skp, int d, int bq, int bk,
               int q_width, int groups, int causal, int window, int q_offset, int sk, int pair,
               int n_split, float scale, float softcap, cudaStream_t stream) {
  const size_t smem =
      smem_bytes<D>(kRows, kTileKeys, q_width * ((bq + kTileKeys - 1) / kTileKeys), true);
  cudaError_t err = prepare(flash_dkv_kernel<D, EXACT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_units = (Skp / bk) * ((bk + kRows - 1) / kRows);
  const dim3 grid(unit_ctas(n_units, pair) * n_split, BH / groups);
  flash_dkv_kernel<D, EXACT><<<grid, dkv_warps<D>() * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(q_idx),
      static_cast<const int*>(q_cnt), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<float*>(dk_part), static_cast<float*>(dv_part), Sqp, Skp, d, bq, bk, q_width,
      groups, causal, window, q_offset, sk, pair, n_split, scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  return static_cast<int>(merge(static_cast<const float*>(dk_part), static_cast<bf16*>(dk),
                                static_cast<const float*>(dv_part), static_cast<bf16*>(dv),
                                (size_t)(BH / groups) * Skp * d, n_split, stream));
}

template <typename Kernel>
int info(Kernel kernel, size_t smem, int warps, int* out) {
  cudaError_t err = prepare(kernel, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, warps * 32, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = ctas;
  out[1] = attr.numRegs;
  out[2] = (int)smem;
  out[3] = (int)attr.localSizeBytes;
  out[4] = warps;
  return 0;
}

}  // namespace

// q, do (BH, Sqp, d), k, v (BH/groups, Skp, d) bf16; lse, delta (BH, Sqp)
// f32; kv_idx (Sqp/bq, width), kv_cnt (Sqp/bq,) int32; dq (BH, Sqp, d)
// bf16.  pair and n_split from the wrapper's plan; for n_split > 1, part is
// (n_split, BH, Sqp, d) f32 scratch (unused, may be null, for 1).  The
// wrapper checks d % 16 == 0 and d <= 128 or d == 256, bq and bk multiples
// of 16 up to 128, Sqp % bq == 0, Skp % bk == 0 and 16-byte alignment.
extern "C" int flash_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, const void* kv_idx,
                        const void* kv_cnt, void* dq, void* part, int BH, int Sqp, int Skp,
                        int d, int bq, int bk, int width, int groups, int causal, int window,
                        int q_offset, int sk, int pair, int n_split, float scale,
                        float softcap, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_dq<64, true>(q, k, v, dout, lse, delta, kv_idx, kv_cnt, dq, part, BH, Sqp,
                               Skp, d, bq, bk, width, groups, causal, window, q_offset, sk,
                               pair, n_split, scale, softcap, s);
  if (d == 80)
    return launch_dq<80, true>(q, k, v, dout, lse, delta, kv_idx, kv_cnt, dq, part, BH, Sqp,
                               Skp, d, bq, bk, width, groups, causal, window, q_offset, sk,
                               pair, n_split, scale, softcap, s);
  if (d == 128)
    return launch_dq<128, true>(q, k, v, dout, lse, delta, kv_idx, kv_cnt, dq, part, BH, Sqp,
                                Skp, d, bq, bk, width, groups, causal, window, q_offset, sk,
                                pair, n_split, scale, softcap, s);
  if (d == 256)
    return launch_dq<256, true>(q, k, v, dout, lse, delta, kv_idx, kv_cnt, dq, part, BH, Sqp,
                                Skp, d, bq, bk, width, groups, causal, window, q_offset, sk,
                                pair, n_split, scale, softcap, s);
  return launch_dq<128, false>(q, k, v, dout, lse, delta, kv_idx, kv_cnt, dq, part, BH, Sqp,
                               Skp, d, bq, bk, width, groups, causal, window, q_offset, sk,
                               pair, n_split, scale, softcap, s);
}

// Same layouts; q_idx (Skp/bk, q_width), q_cnt (Skp/bk,) int32 (the
// transposed schedule); dk, dv (BH/groups, Skp, d) bf16; for n_split > 1,
// dk_part and dv_part are (n_split, BH/groups, Skp, d) f32 scratch.
extern "C" int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, const void* q_idx,
                         const void* q_cnt, void* dk, void* dv, void* dk_part, void* dv_part,
                         int BH, int Sqp, int Skp, int d, int bq, int bk, int q_width,
                         int groups, int causal, int window, int q_offset, int sk, int pair,
                         int n_split, float scale, float softcap, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_dkv<64, true>(q, k, v, dout, lse, delta, q_idx, q_cnt, dk, dv, dk_part,
                                dv_part, BH, Sqp, Skp, d, bq, bk, q_width, groups, causal,
                                window, q_offset, sk, pair, n_split, scale, softcap, s);
  if (d == 80)
    return launch_dkv<80, true>(q, k, v, dout, lse, delta, q_idx, q_cnt, dk, dv, dk_part,
                                dv_part, BH, Sqp, Skp, d, bq, bk, q_width, groups, causal,
                                window, q_offset, sk, pair, n_split, scale, softcap, s);
  if (d == 128)
    return launch_dkv<128, true>(q, k, v, dout, lse, delta, q_idx, q_cnt, dk, dv, dk_part,
                                 dv_part, BH, Sqp, Skp, d, bq, bk, q_width, groups, causal,
                                 window, q_offset, sk, pair, n_split, scale, softcap, s);
  if (d == 256)
    return launch_dkv<256, true>(q, k, v, dout, lse, delta, q_idx, q_cnt, dk, dv, dk_part,
                                 dv_part, BH, Sqp, Skp, d, bq, bk, q_width, groups, causal,
                                 window, q_offset, sk, pair, n_split, scale, softcap, s);
  return launch_dkv<128, false>(q, k, v, dout, lse, delta, q_idx, q_cnt, dk, dv, dk_part,
                                dv_part, BH, Sqp, Skp, d, bq, bk, q_width, groups, causal,
                                window, q_offset, sk, pair, n_split, scale, softcap, s);
}

// The generic instantiations at any d (the yardsticks of the exact ones).
extern "C" int flash_dq_generic(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, const void* kv_idx,
                                const void* kv_cnt, void* dq, void* part, int BH, int Sqp,
                                int Skp, int d, int bq, int bk, int width, int groups,
                                int causal, int window, int q_offset, int sk, int pair,
                                int n_split, float scale, float softcap, void* stream) {
  return launch_dq<128, false>(q, k, v, dout, lse, delta, kv_idx, kv_cnt, dq, part, BH, Sqp,
                               Skp, d, bq, bk, width, groups, causal, window, q_offset, sk,
                               pair, n_split, scale, softcap, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_dkv_generic(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 const void* q_idx, const void* q_cnt, void* dk, void* dv,
                                 void* dk_part, void* dv_part, int BH, int Sqp, int Skp, int d,
                                 int bq, int bk, int q_width, int groups, int causal,
                                 int window, int q_offset, int sk, int pair, int n_split,
                                 float scale, float softcap, void* stream) {
  return launch_dkv<128, false>(q, k, v, dout, lse, delta, q_idx, q_cnt, dk, dv, dk_part,
                                dv_part, BH, Sqp, Skp, d, bq, bk, q_width, groups, causal,
                                window, q_offset, sk, pair, n_split, scale, softcap,
                                static_cast<cudaStream_t>(stream));
}

// The launch each instantiation for head_dim d gets at schedule width
// `width` (bk = bq = 128): out = {CTAs resident per SM, registers a thread,
// dynamic shared bytes, local (spill) bytes a thread, warps a CTA}.
template <int D, bool EXACT>
int dq_info(int width, int* out) {
  constexpr int KT = dq_keys<D>();
  return info(flash_dq_kernel<D, EXACT>,
              smem_bytes<D>(16 * dq_warps<D>(), KT, width * (128 / KT), false), dq_warps<D>(),
              out);
}

template <int D, bool EXACT>
int dkv_info(int width, int* out) {
  return info(flash_dkv_kernel<D, EXACT>, smem_bytes<D>(kRows, kTileKeys, 2 * width, true),
              dkv_warps<D>(), out);
}

extern "C" int flash_dq_info(int d, int width, int* out) {
  if (d == 64) return dq_info<64, true>(width, out);
  if (d == 80) return dq_info<80, true>(width, out);
  if (d == 128) return dq_info<128, true>(width, out);
  if (d == 256) return dq_info<256, true>(width, out);
  return dq_info<128, false>(width, out);
}

extern "C" int flash_dkv_info(int d, int width, int* out) {
  if (d == 64) return dkv_info<64, true>(width, out);
  if (d == 80) return dkv_info<80, true>(width, out);
  if (d == 128) return dkv_info<128, true>(width, out);
  if (d == 256) return dkv_info<256, true>(width, out);
  return dkv_info<128, false>(width, out);
}

extern "C" int flash_dq_generic_info(int, int width, int* out) {
  return dq_info<128, false>(width, out);
}

extern "C" int flash_dkv_generic_info(int, int width, int* out) {
  return dkv_info<128, false>(width, out);
}
