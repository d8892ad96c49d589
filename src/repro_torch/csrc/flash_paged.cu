// Paged-prefix flash attention: the prefix phase of a suffix-only prefill.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_paged_kernel
// (pallas_call in _paged_call).  Suffix queries q (B, H, Sq, d) bf16 attend
// the first ctx[b] keys of a paged KV pool pk/pv (N, bs, KV, d) bf16, whose
// logical page j of row b is physical page table[b, j] (table (B, T) int32,
// unowned entries hold the sentinel N; reads clamp it to N - 1, as the TPU
// kernel's index map does, though no live key lies on one).  Key kpos is
// live iff kpos < n_keys = min(ctx[b], T * bs); there is no causal mask,
// because every prefix key precedes every suffix query.  Scores are
// q.k * scale, then the optional softcap c*tanh(s/c).  Outputs o (B, H, Sq,
// d) bf16 and the row logsumexp lse (B, H, Sq) f32; a row with no live key
// gets o = 0 and lse = -1e30 (not the forward kernel's +1e30: the logsumexp
// merge with the causal self phase needs exp(lse - m) to underflow to
// exactly 0).
//
// Bound on the H100: the bytes are q and o once and the live K/V pages once
// per KV head; the work is 4 d flops per (query, live key) pair.  At a
// serving suffix (Sq 16, ctx 512) both are tiny (under 1 us): latency, and
// the number of SMs a launch reaches, bound it; at Sq = 128 over 4096 keys,
// the tensor cores.
//
// Design: GQA is folded into the rows.  The G = H / KV query heads of one
// KV head are adjacent in q, so for (b, kv) the R = G * Sq rows
// q[b, kv*G : (kv+1)*G] are one contiguous (R, d) matrix that attends one
// key sequence.  A CTA of 4 warps (16 rows each) takes 64 of those rows for
// one (b, kv) and one split of the key walk, on the core of
// csrc/flash_core.cuh (mma.sync m16n8k16 with ldmatrix operands; S, P and O
// in registers).  The key walk is split (blockIdx.z): the wrapper's plan
// (kernels/flash_attention.py::paged_split_plan) gives n_split from shapes
// alone, and split s covers the 128-key tiles [s * n / n_split, (s + 1) * n
// / n_split) of the n = ceil(T * bs / 128) in T * bs, clipped here to n_keys
// read from ctx on the device.  The CTA walks its range in 64-key tiles
// through a two-stage cp.async ring: while the warps compute tile t, tile
// t + 1's rows, resolved through the table one tile earlier, are in flight,
// and 64 threads read the table entries of tile t + 2 (a load whose latency
// the tile's math covers).  Keys past the range are zero-filled by the
// src-size 0 form of cp.async, and only the last tile evaluates the
// kpos < end mask.  The pool is read at its own (N, bs, KV, d) strides:
// nothing is transposed or copied per call.  With n_split = 1 the CTA
// writes o and lse; otherwise each split writes its unnormalised f32 o, m
// and l, and a second kernel of this source merges the splits in the fixed
// order s = 0..n_split-1 (m* = max m_s, l = sum l_s e^(m_s - m*), o = sum
// o_s e^(m_s - m*) / max(l, 1e-30), lse = l > 0 ? m* + log l : -1e30).  Two
// CTAs (8 warps; 168 registers, 87.6 KB of shared memory, no spill) are
// resident per SM at d = 128.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py): the serve path's
// shape (one 16-row suffix over ctx 512, n_split 5, 120 CTAs) 20 us, from
// 113 us unsplit in the first version; Sq = 128 over up to 4096 keys (no
// split) 0.337 ms, 116 TFLOP/s, 11.8% of its operations bound.
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "flash_core.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::kTileKeys;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // folded query rows a CTA
constexpr int kSplitKeys = 128;     // the unit of a split's key range
constexpr int kMergeThreads = 256;

template <int D>
size_t smem_bytes() {
  // Q rows, two K and two V stages, two stages of resolved key rows
  return (size_t)flash::tile_bytes<D>(kRows + 4 * kTileKeys) + sizeof(int) * 2 * kTileKeys;
}

template <int D, bool EXACT>
__global__ void __launch_bounds__(kThreads, 2)
flash_paged_kernel(const bf16* __restrict__ q, const bf16* __restrict__ pk,
                   const bf16* __restrict__ pv, const int* __restrict__ table,
                   const int* __restrict__ ctx, bf16* __restrict__ o,
                   float* __restrict__ lse, float* __restrict__ o_part,
                   float* __restrict__ m_part, float* __restrict__ l_part, int R, int N,
                   int bs, int KV, int T, int d_rt, int n_split, float scale, float softcap) {
  constexpr int DP = flash::row_pad<D>();
  constexpr int kStage = flash::tile_bytes<D>(kTileKeys);
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t qs = flash::smem_addr(smem);            // kRows Q rows
  const uint32_t ks = qs + flash::tile_bytes<D>(kRows);  // 2 K stages
  const uint32_t vs = ks + 2 * kStage;                   // 2 V stages
  // [2][kTileKeys] resolved pool rows
  int* key_rows = reinterpret_cast<int*>(smem + flash::tile_bytes<D>(kRows + 4 * kTileKeys));

  const int d = EXACT ? D : d_rt;
  const int cpr = d / 8;
  const int bkv = blockIdx.y;  // b * KV + kv
  const int b = bkv / KV, kv = bkv % KV;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, R - row0);
  const int split = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const bool live = warp * 16 < rows;

  // this split's keys [k_beg, k_end), clipped to the live prefix
  const int n_table = T * bs;
  const int units = (n_table + kSplitKeys - 1) / kSplitKeys;
  const int k_beg = (int)((long long)split * units / n_split) * kSplitKeys;
  const int k_end = min(min((int)((long long)(split + 1) * units / n_split) * kSplitKeys,
                            n_table),
                        min(ctx[b], n_table));
  const int n_tiles = k_end > k_beg ? (k_end - k_beg + kTileKeys - 1) / kTileKeys : 0;

  // pool row (page * bs + kpos % bs) of the tile's key c, -1 past the range;
  // read by the threads c < kTileKeys
  auto resolve = [&](int t) -> int {
    const int kpos = k_beg + t * kTileKeys + (int)threadIdx.x;
    if (t >= n_tiles || kpos >= k_end) return -1;
    const int page = min(max(table[(size_t)b * T + kpos / bs], 0), N - 1);
    return page * bs + kpos % bs;
  };
  if (threadIdx.x < kTileKeys) {
    key_rows[threadIdx.x] = resolve(0);
    key_rows[kTileKeys + threadIdx.x] = resolve(1);
  }
  const size_t q_row0 = (size_t)bkv * R + row0;
  for (int c = threadIdx.x; c < kRows * cpr; c += kThreads) {
    const int r = c / cpr, col = (c % cpr) * 8;
    const bool ok = r < rows;
    flash::cp_async16(qs + 2 * (r * DP + col), q + (q_row0 + (ok ? r : 0)) * d + col, ok);
  }
  __syncthreads();  // tiles 0 and 1's rows

  auto issue = [&](int t, int stage) {
    const int* kr = key_rows + (t & 1) * kTileKeys;
    for (int c = threadIdx.x; c < kTileKeys * cpr; c += kThreads) {
      const int r = c / cpr, col = (c % cpr) * 8;
      const int row = kr[r];
      const size_t g = ((size_t)max(row, 0) * KV + kv) * d + col;
      const uint32_t at = stage * kStage + 2 * (r * DP + col);
      flash::cp_async16(ks + at, pk + g, row >= 0);
      flash::cp_async16(vs + at, pv + g, row >= 0);
    }
  };
  if (n_tiles > 0) issue(0, 0);
  flash::cp_async_commit();

  const flash::Scores sc(scale, softcap);
  flash::WarpRows<D, EXACT> acc;
  acc.init();
  int ahead = -1;  // this thread's table row of tile t + 2
  flash::key_walk(
      n_tiles,
      [&](int t, int stage) {
        issue(t, stage);
        if (threadIdx.x < kTileKeys) ahead = resolve(t + 1);
      },
      [&](int t, int stage) {
        if (!live) return;
        const int key0 = k_beg + t * kTileKeys;
        const int n_live = min(kTileKeys, k_end - key0);
        acc.attend(qs + warp * 16 * DP * 2, ks + stage * kStage, vs + stage * kStage, d,
                   (n_live + 15) / 16, sc, (n_live & 15) != 0,
                   [&](int, int c) { return c < n_live; });
      },
      [&](int t) {
        // tile t's slot is free (its copies were issued before this tile's
        // barrier); it takes tile t + 2's rows
        if (threadIdx.x < kTileKeys) key_rows[(t & 1) * kTileKeys + threadIdx.x] = ahead;
      });

  if (!live) return;
  const size_t g0 = q_row0 + warp * 16;  // folded row = the (b, h, s) row of q
  if (n_split == 1) {
    acc.store(o + g0 * d, lse + g0, d, rows - warp * 16, -1e30f);
  } else {
    const size_t all = (size_t)gridDim.y * R;
    acc.store_partial(o_part + (split * all + g0) * d, m_part + split * all + g0,
                      l_part + split * all + g0, d, rows - warp * 16);
  }
}

// o, lse from the n_split partials of `rows` rows, 8 columns a thread.
__global__ void __launch_bounds__(kMergeThreads)
paged_merge_kernel(const float* __restrict__ o_part, const float* __restrict__ m_part,
                   const float* __restrict__ l_part, bf16* __restrict__ o,
                   float* __restrict__ lse, int rows, int d, int n_split) {
  const int cpr = d / 8;
  const long long i = (long long)blockIdx.x * kMergeThreads + threadIdx.x;
  if (i >= (long long)rows * cpr) return;
  const int row = (int)(i / cpr), col = (int)(i % cpr) * 8;
  float m_all = -1e30f;
  for (int s = 0; s < n_split; ++s) m_all = fmaxf(m_all, m_part[(size_t)s * rows + row]);
  float l = 0.0f, acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int s = 0; s < n_split; ++s) {
    const size_t r = (size_t)s * rows + row;
    const float w = expf(m_part[r] - m_all);
    l += l_part[r] * w;
    const float4* src = reinterpret_cast<const float4*>(o_part + r * d + col);
    const float4 a = src[0], c = src[1];
    acc[0] += a.x * w; acc[1] += a.y * w; acc[2] += a.z * w; acc[3] += a.w * w;
    acc[4] += c.x * w; acc[5] += c.y * w; acc[6] += c.z * w; acc[7] += c.w * w;
  }
  const float den = fmaxf(l, flash::kEps);
  uint4 out;
  out.x = flash::pack_bf16(acc[0] / den, acc[1] / den);
  out.y = flash::pack_bf16(acc[2] / den, acc[3] / den);
  out.z = flash::pack_bf16(acc[4] / den, acc[5] / den);
  out.w = flash::pack_bf16(acc[6] / den, acc[7] / den);
  *reinterpret_cast<uint4*>(o + (size_t)row * d + col) = out;
  if (col == 0) lse[row] = l > 0.0f ? m_all + logf(den) : -1e30f;
}

template <int D, bool EXACT>
cudaError_t prepare() {
  cudaError_t err = cudaFuncSetAttribute(flash_paged_kernel<D, EXACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes<D>());
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(flash_paged_kernel<D, EXACT>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int D, bool EXACT>
int launch(const void* q, const void* pk, const void* pv, const void* table, const void* ctx,
           void* o, void* lse, void* o_part, void* m_part, void* l_part, int B, int H, int Sq,
           int N, int bs, int KV, int T, int d, int n_split, float scale, float softcap,
           cudaStream_t stream) {
  cudaError_t err = prepare<D, EXACT>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int R = (H / KV) * Sq;  // folded rows of one (b, kv)
  const dim3 grid((R + kRows - 1) / kRows, B * KV, n_split);
  flash_paged_kernel<D, EXACT><<<grid, kThreads, smem_bytes<D>(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(pk), static_cast<const bf16*>(pv),
      static_cast<const int*>(table), static_cast<const int*>(ctx), static_cast<bf16*>(o),
      static_cast<float*>(lse), static_cast<float*>(o_part), static_cast<float*>(m_part),
      static_cast<float*>(l_part), R, N, bs, KV, T, d, n_split, scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  const int rows = B * H * Sq;
  const long long work = (long long)rows * (d / 8);
  paged_merge_kernel<<<(unsigned)((work + kMergeThreads - 1) / kMergeThreads), kMergeThreads, 0,
                       stream>>>(static_cast<const float*>(o_part),
                                 static_cast<const float*>(m_part),
                                 static_cast<const float*>(l_part), static_cast<bf16*>(o),
                                 static_cast<float*>(lse), rows, d, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool EXACT>
int info(int* out) {
  cudaError_t err = prepare<D, EXACT>();
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, flash_paged_kernel<D, EXACT>);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, flash_paged_kernel<D, EXACT>,
                                                        kThreads, smem_bytes<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = ctas;
  out[1] = attr.numRegs;
  out[2] = (int)smem_bytes<D>();
  out[3] = (int)attr.localSizeBytes;
  out[4] = kWarps;
  return 0;
}

}  // namespace

// q (B, H, Sq, d), pool pk/pv (N, bs, KV, d) bf16; table (B, T), ctx (B,)
// int32; o (B, H, Sq, d) bf16, lse (B, H, Sq) f32.  n_split from the
// wrapper's plan; for n_split > 1, o_part (n_split, B*H*Sq, d) and m_part,
// l_part (n_split, B*H*Sq) f32 scratch (unused, may be null, for 1).  The
// wrapper checks d % 16 == 0, d <= 128, H % KV == 0, contiguity and 16-byte
// alignment.  d = 80 and d = 128 run their own instantiations; other d the
// generic one.
extern "C" int flash_paged(const void* q, const void* pk, const void* pv,
                           const void* table, const void* ctx, void* o, void* lse,
                           void* o_part, void* m_part, void* l_part, int B, int H, int Sq,
                           int N, int bs, int KV, int T, int d, int n_split, float scale,
                           float softcap, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (d == 80)
    return launch<80, true>(q, pk, pv, table, ctx, o, lse, o_part, m_part, l_part, B, H, Sq, N,
                            bs, KV, T, d, n_split, scale, softcap, s);
  if (d == 128)
    return launch<128, true>(q, pk, pv, table, ctx, o, lse, o_part, m_part, l_part, B, H, Sq,
                             N, bs, KV, T, d, n_split, scale, softcap, s);
  return launch<128, false>(q, pk, pv, table, ctx, o, lse, o_part, m_part, l_part, B, H, Sq, N,
                            bs, KV, T, d, n_split, scale, softcap, s);
}

// The paged kernel's launch for head_dim d: out = {CTAs resident per SM,
// registers a thread, dynamic shared bytes, local (spill) bytes a thread,
// warps a CTA}.
extern "C" int flash_paged_info(int d, int* out) {
  if (d == 80) return info<80, true>(out);
  if (d == 128) return info<128, true>(out);
  return info<128, false>(out);
}
