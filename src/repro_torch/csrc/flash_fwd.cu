// Flash-attention forward over a host-built AttnSchedule (online softmax).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_fwd_kernel
// (pallas_call in _fwd_call).  q (BH, Sqp, d), k/v (BH/G, Skp, d) bf16;
// query row bh reads KV row bh / G (GQA, no repeated K/V).  For q-block qb
// the kernel walks exactly kv_idx[qb, :kv_cnt[qb]] (core/attn_sched.py) and
// never rebuilds the schedule.  Outputs o (BH, Sqp, d) bf16 and the per-row
// logsumexp lse (BH, Sqp) f32; a row with no live key gets o = 0 and
// lse = +1e30, as in the TPU kernel.  Masks: causal kpos <= qpos, window
// kpos > qpos - window, kpos < sk for the padded tail, with
// qpos = q_offset + qb * bq + r; scores q.k * scale, then the optional
// softcap c * tanh(s / c); p rounded to bf16 before p @ v as the TPU kernel
// does, l summed from the f32 p.
//
// Bound on the H100: at prefill lengths the work is 4 d flops per live
// (q, k) pair against q, k, v and o read or written once, so the tensor
// cores bound it (danube's S = 6144, window 4096: 0.22 TFLOP against 5 MB).
//
// Design (csrc/flash_core.cuh holds the warp-level core shared with K12):
// a CTA takes the rows of one (bh, q-block): 8 warps (128 rows) at
// d <= 80 (hymba's d = 64 and danube's d = 80) and d = 256, 4 warps (64 rows, so a
// q-block of 128 is two CTAs) at d = 128 and in the generic instantiation,
// each warp 16 rows.  Q is copied once into
// shared memory; its ldmatrix fragments are re-read there each tile.  The
// CTA consumes each schedule block of bk keys as 64-key tiles (a bk = 128
// block is two) through a two-stage cp.async ring: tile t + 1's K and V
// rows (contiguous, at KV row bh / G) are copied while the warps run tile t
// on the tensor cores (mma.sync m16n8k16, S, P and O in registers).  A warp
// evaluates the element mask only on a tile that crosses the diagonal, the
// window's edge or sk for its 16 rows.  Two CTAs are resident per SM at
// d = 64 and d = 80 (16 warps: 120 registers under the launch bound's 128,
// 55.3 / 67.6 KB of shared memory) and at d = 128 (8 warps: 162 registers,
// 87 KB); no spill.
//
// d = 256 (gemma3): O alone is 128 floats a thread (241 registers under a
// 255 cap: one 8-warp CTA an SM), and a 528-byte padded row makes a 64-key
// ring 135 KB.  The ring takes 32-key tiles (S and P halve too): Q's 128
// rows 67.6 KB + the ring 67.6 KB.  Timed against 4 warps with 32-key
// tiles (2 CTAs an SM) and 4 warps with 64-key tiles (1 CTA) by
// scripts/flash_d256_tiles.py: 0.130 / 0.215 ms against 0.135 / 0.220 and
// 0.203 / 0.295 at gemma3's local / global S = 2048 (PERF.md section 6).
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py): the 8 timed cases
// sum to 1.47 ms (scaled_dot_product_attention 2.32, the first version
// 12.8); danube's S = 6144, window 4096 runs at 157 TFLOP/s, 15.9% of its
// operations bound.  wgmma with TMA and warp specialisation is the next step
// (PERF.md section 7).
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "flash_core.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::kTileKeys;

template <int D>
__host__ __device__ constexpr int warps() { return D <= 80 || D > 128 ? 8 : 4; }

// CTAs an SM the launch bound asks for: 1 at d = 256 (registers).
template <int D>
__host__ __device__ constexpr int min_ctas() { return D > 128 ? 1 : 2; }

// Keys a ring tile: 32 at d = 256 (see above), else 64.
template <int D>
__host__ __device__ constexpr int tile_keys() { return D > 128 ? 32 : kTileKeys; }

template <int D>
size_t smem_bytes(int width) {
  // Q rows, two K and two V stages, the q-block's walk
  return (size_t)flash::tile_bytes<D>(warps<D>() * 16 + 4 * tile_keys<D>()) +
         sizeof(int) * (size_t)width;
}

template <int D, bool EXACT>
__global__ void __launch_bounds__(warps<D>() * 32, min_ctas<D>())
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ kv_idx,
                 const int* __restrict__ kv_cnt, bf16* __restrict__ o,
                 float* __restrict__ lse, int Sqp, int Skp, int d_rt, int bq, int bk,
                 int width, int groups, int causal, int window, int q_offset, int sk,
                 float scale, float softcap) {
  constexpr int kThreads = warps<D>() * 32;
  constexpr int kRows = warps<D>() * 16;
  constexpr int DP = flash::row_pad<D>();
  constexpr int KT = tile_keys<D>();
  constexpr int kStage = flash::tile_bytes<D>(KT);
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t qs = flash::smem_addr(smem);     // kRows Q rows
  const uint32_t ks = qs + flash::tile_bytes<D>(kRows);  // 2 K stages
  const uint32_t vs = ks + 2 * kStage;            // 2 V stages
  int* idx_s = reinterpret_cast<int*>(smem + flash::tile_bytes<D>(kRows + 4 * KT));

  const int d = EXACT ? D : d_rt;
  const int cpr = d / 8;  // 16-byte chunks a row
  const int n_part = (bq + kRows - 1) / kRows;
  const int qb = blockIdx.x / n_part;
  const int row0 = (blockIdx.x % n_part) * kRows;
  const int rows = min(kRows, bq - row0);  // a multiple of 16
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const bool live = warp * 16 < rows;

  // row indices (< 2^31 rows): 32-bit, so fewer registers live over the walk
  const int q_row0 = bh * Sqp + qb * bq + row0;
  const int kv_row0 = (bh / groups) * Skp;  // KV row bh / G
  const int* walk = kv_idx + (size_t)qb * width;
  const int count = kv_cnt[qb];
  const int nsub = (bk + KT - 1) / KT;
  const int n_tiles = count * nsub;
  for (int i = threadIdx.x; i < count; i += kThreads) idx_s[i] = walk[i];

  for (int c = threadIdx.x; c < kRows * cpr; c += kThreads) {
    const int r = c / cpr, col = (c % cpr) * 8;
    const bool ok = r < rows;
    flash::cp_async16(qs + 2 * (r * DP + col), q + (size_t)(q_row0 + (ok ? r : 0)) * d + col,
                      ok);
  }
  // tile t: sub-tile t % nsub of schedule block kb = walk[t / nsub]
  auto issue_block = [&](int t, int stage, int kb) {
    const int sub = t % nsub;
    const int key0 = kb * bk + sub * KT;
    const int nk = min(KT, bk - sub * KT);
    for (int c = threadIdx.x; c < nk * cpr; c += kThreads) {
      const int r = c / cpr, col = (c % cpr) * 8;
      const size_t g = (size_t)(kv_row0 + key0 + r) * d + col;
      const uint32_t at = stage * kStage + 2 * (r * DP + col);
      flash::cp_async16(ks + at, k + g, true);
      flash::cp_async16(vs + at, v + g, true);
    }
  };
  if (n_tiles > 0) issue_block(0, 0, walk[0]);
  flash::cp_async_commit();

  const int q_lo = q_offset + qb * bq + row0 + warp * 16;  // the warp's first qpos
  const flash::Scores sc(scale, softcap);
  flash::WarpRows<D, EXACT> acc;
  acc.init();
  flash::key_walk(
      n_tiles,
      [&](int t, int stage) { issue_block(t, stage, idx_s[t / nsub]); },
      [&](int t, int stage) {
        if (!live) return;
        const int sub = t % nsub;
        const int key0 = idx_s[t / nsub] * bk + sub * KT;
        const int nk = min(KT, bk - sub * KT);
        const int k_hi = key0 + nk - 1;
        const bool inside = k_hi < sk && (!causal || k_hi <= q_lo) &&
                            (!window || key0 > q_lo + 15 - window);
        acc.template attend<KT>(qs + warp * 16 * DP * 2, ks + stage * kStage, vs + stage * kStage, d,
                   nk / 16, sc, !inside,
                   [&](int r, int c) {
                     const int kpos = key0 + c, qpos = q_lo + r;
                     return kpos < sk && (!causal || kpos <= qpos) &&
                            (!window || kpos > qpos - window);
                   });
      },
      [](int) {});

  if (live)
    acc.store(o + (size_t)(q_row0 + warp * 16) * d, lse + q_row0 + warp * 16, d, rows - warp * 16,
              1e30f);
}

template <int D, bool EXACT>
cudaError_t prepare(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D, EXACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(flash_fwd_kernel<D, EXACT>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int D, bool EXACT>
int launch(const void* q, const void* k, const void* v, const void* kv_idx,
           const void* kv_cnt, void* o, void* lse, int BH, int Sqp, int Skp, int d, int bq,
           int bk, int width, int groups, int causal, int window, int q_offset, int sk,
           float scale, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(width);
  cudaError_t err = prepare<D, EXACT>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kRows = warps<D>() * 16;
  const dim3 grid((Sqp / bq) * ((bq + kRows - 1) / kRows), BH);
  flash_fwd_kernel<D, EXACT><<<grid, warps<D>() * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(kv_idx), static_cast<const int*>(kv_cnt),
      static_cast<bf16*>(o), static_cast<float*>(lse), Sqp, Skp, d, bq, bk, width, groups,
      causal, window, q_offset, sk, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool EXACT>
int info(int width, int* out) {
  const size_t smem = smem_bytes<D>(width);
  cudaError_t err = prepare<D, EXACT>(smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, flash_fwd_kernel<D, EXACT>);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, flash_fwd_kernel<D, EXACT>,
                                                        warps<D>() * 32, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = ctas;
  out[1] = attr.numRegs;
  out[2] = (int)smem;
  out[3] = (int)attr.localSizeBytes;
  out[4] = warps<D>();
  return 0;
}

}  // namespace

// q (BH, Sqp, d), k/v (BH/groups, Skp, d) bf16; kv_idx (Sqp/bq, width),
// kv_cnt (Sqp/bq,) int32; o (BH, Sqp, d) bf16, lse (BH, Sqp) f32.  The
// wrapper checks d % 16 == 0 and d <= 128 or d == 256, bq and bk multiples
// of 16 up to 128, Sqp % bq == 0, Skp % bk == 0 and 16-byte alignment.
// d = 64, 80, 128 and 256 run their own instantiations; other d the generic
// one.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* kv_idx, const void* kv_cnt, void* o, void* lse,
                         int BH, int Sqp, int Skp, int d, int bq, int bk, int width,
                         int groups, int causal, int window, int q_offset, int sk,
                         float scale, float softcap, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch<64, true>(q, k, v, kv_idx, kv_cnt, o, lse, BH, Sqp, Skp, d, bq, bk, width,
                            groups, causal, window, q_offset, sk, scale, softcap, s);
  if (d == 80)
    return launch<80, true>(q, k, v, kv_idx, kv_cnt, o, lse, BH, Sqp, Skp, d, bq, bk, width,
                            groups, causal, window, q_offset, sk, scale, softcap, s);
  if (d == 128)
    return launch<128, true>(q, k, v, kv_idx, kv_cnt, o, lse, BH, Sqp, Skp, d, bq, bk, width,
                             groups, causal, window, q_offset, sk, scale, softcap, s);
  if (d == 256)
    return launch<256, true>(q, k, v, kv_idx, kv_cnt, o, lse, BH, Sqp, Skp, d, bq, bk, width,
                             groups, causal, window, q_offset, sk, scale, softcap, s);
  return launch<128, false>(q, k, v, kv_idx, kv_cnt, o, lse, BH, Sqp, Skp, d, bq, bk, width,
                            groups, causal, window, q_offset, sk, scale, softcap, s);
}

// The generic instantiation at any d (the yardstick of the exact ones).
extern "C" int flash_fwd_generic(const void* q, const void* k, const void* v,
                                 const void* kv_idx, const void* kv_cnt, void* o, void* lse,
                                 int BH, int Sqp, int Skp, int d, int bq, int bk, int width,
                                 int groups, int causal, int window, int q_offset, int sk,
                                 float scale, float softcap, void* stream) {
  return launch<128, false>(q, k, v, kv_idx, kv_cnt, o, lse, BH, Sqp, Skp, d, bq, bk, width,
                            groups, causal, window, q_offset, sk, scale, softcap,
                            static_cast<cudaStream_t>(stream));
}

// The launch the instantiation for head_dim d gets at schedule width
// `width`: out = {CTAs resident per SM, registers a thread, dynamic shared
// bytes, local (spill) bytes a thread, warps a CTA}.
extern "C" int flash_fwd_info(int d, int width, int* out) {
  if (d == 64) return info<64, true>(width, out);
  if (d == 80) return info<80, true>(width, out);
  if (d == 128) return info<128, true>(width, out);
  if (d == 256) return info<256, true>(width, out);
  return info<128, false>(width, out);
}

extern "C" int flash_fwd_generic_info(int, int width, int* out) {
  return info<128, false>(width, out);
}
