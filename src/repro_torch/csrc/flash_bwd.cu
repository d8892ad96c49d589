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
// q's/k's type before ds @ k and ds^T @ q, f32 accumulators, outputs rounded
// once.  Masked score slots (causal, window, padded keys kpos >= sk) get
// p = 0 (the reference's exp(NEG_INF - lse) = 0); a dead query row carries
// lse = +1e30 from the forward, so every p of it is 0, never NaN.
//
// Design (no atomics; every sum in a fixed order, so results repeat run to
// run): the TPU kernels carry accumulators across sequential grid axes; here
// a loop inside one CTA takes their place.
//  * K10: one CTA of 4 warps per (bh, 64-row half of a q-block); each warp
//    owns 16 query rows and keeps its dq (16 x d) in wmma accumulators.  Per
//    live KV block the CTA stages K and V (bk x d); each warp computes its
//    scores and do @ v^T 16 columns at a time into a small f32 tile, forms
//    ds there, and stores it as bf16 (16 x bk) for the ds @ k product.
//  * K11: one CTA of 8 warps per (b*KV row, KV block); warp w owns KV rows
//    16w..16w+15 and keeps their dk and dv (16 x d each) in wmma
//    accumulators across the G group members and the live q-blocks.  Per
//    (member, q-block) the CTA stages q, do (bq x d), lse and delta; each
//    warp computes s^T and (do @ v^T)^T 16 q-columns at a time, forms p^T
//    and ds^T (bf16, 16 x bq), then dv += p^T @ do and dk += ds^T @ q.
// head_dim is a runtime multiple of 16 up to 128 (danube: 80).  Shared
// memory at bq = bk = 128, d = 80: K10 ~92 KB, K11 ~173 KB, both above the
// 48 KB static limit, so the entries raise it with cudaFuncSetAttribute.
//
// Bound on the H100: per live (q, k) pair K10 does 6*d flops (three
// products) and K11 8*d (four), tensor-core work at prefill lengths; the
// bytes are q, k, v, do, lse, delta and the outputs once.  This first
// version uses synchronous loads and wmma (no TMA, no wgmma); its times
// against the bound are in PERF.md.
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

using bf16 = __nv_bfloat16;
constexpr int kMaxD = 128;

// One masked, softcapped score slot -> (p, ds) in f32.
struct Score {
  int bq, bk, causal, window, q_offset, sk;
  float scale, softcap;

  __device__ inline void operator()(float s_raw, float dp, float lse, float delta,
                                    int qpos, int kpos, float& p, float& ds) const {
    const float u = s_raw * scale;
    float s = u, chain = 1.0f;
    if (softcap != 0.0f) {
      const float t = tanhf(u / softcap);
      s = softcap * t;
      chain = 1.0f - t * t;
    }
    const bool ok = kpos < sk && (!causal || kpos <= qpos) &&
                    (!window || kpos > qpos - window);
    p = ok ? expf(s - lse) : 0.0f;
    ds = p * (dp - delta) * scale * chain;
  }
};

// Copy `rows` rows of d bf16 (16-byte vectors) into a padded tile; rows at
// or beyond `valid` are zero.
__device__ inline void stage(bf16* dst, int ld, const bf16* src, int rows, int valid,
                             int d, int nthreads) {
  const int dv8 = d / 8;
  for (int t = threadIdx.x; t < rows * dv8; t += nthreads) {
    const int r = t / dv8, c = (t % dv8) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + (size_t)r * d + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// (16 x 16) f32 = A (16 x d, row-major) @ B^T where B is (16 x d) row-major
// (read as a column-major d x 16 matrix), stored row-major with ld 16.
__device__ inline void rows_dot(float* out, const bf16* a, const bf16* b, int ld, int d) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.0f);
  for (int kt = 0; kt < d / 16; ++kt) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
    wmma::load_matrix_sync(fa, a + kt * 16, ld);
    wmma::load_matrix_sync(fb, b + kt * 16, ld);
    wmma::mma_sync(acc, fa, fb, acc);
  }
  wmma::store_matrix_sync(out, acc, 16, wmma::mem_row_major);
}

using Frag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// acc[nt] (16 x 16 column block nt of a 16 x d tile) += a (16 x n) @ b (n x d).
__device__ inline void acc_product(Frag* acc, const bf16* a, int lda, const bf16* b,
                                   int ldb, int n, int d) {
#pragma unroll
  for (int nt = 0; nt < kMaxD / 16; ++nt) {
    if (nt < d / 16) {
      for (int kt = 0; kt < n / 16; ++kt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, a + kt * 16, lda);
        wmma::load_matrix_sync(fb, b + kt * 16 * ldb + nt * 16, ldb);
        wmma::mma_sync(acc[nt], fa, fb, acc[nt]);
      }
    }
  }
}

// Round a warp's 16 x d accumulators to bf16 rows dst[r * d + c].
__device__ inline void store_rows(bf16* dst, Frag* acc, float* tile, int d) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int nt = 0; nt < kMaxD / 16; ++nt) {
    if (nt < d / 16) {
      wmma::store_matrix_sync(tile, acc[nt], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32)
        dst[(size_t)(e / 16) * d + nt * 16 + e % 16] = __float2bfloat16(tile[e]);
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------- K10: dq

constexpr int kDqWarps = 4;
constexpr int kDqThreads = kDqWarps * 32;
constexpr int kDqRows = kDqWarps * 16;

__host__ __device__ inline size_t dq_smem(int d, int bk) {
  const size_t dp = d + 8, sp = bk + 8;
  return sizeof(bf16) * (2 * kDqRows * dp + 2 * bk * dp + kDqRows * sp) +
         sizeof(float) * (kDqWarps * 2 * 256 + 2 * kDqRows);
}

__global__ void __launch_bounds__(kDqThreads)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ kv_idx, const int* __restrict__ kv_cnt,
                bf16* __restrict__ dq, int Sqp, int Skp, int d, int width,
                int groups, Score sc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int dp = d + 8, sp = sc.bk + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kDqRows * dp;
  bf16* ks = dos + kDqRows * dp;
  bf16* vs = ks + sc.bk * dp;
  bf16* dss = vs + sc.bk * dp;                             // kDqRows x sp
  float* tiles = reinterpret_cast<float*>(dss + kDqRows * sp);  // 2 x 256 per warp
  float* lse_s = tiles + kDqWarps * 2 * 256;
  float* delta_s = lse_s + kDqRows;

  const int n_half = (sc.bq + kDqRows - 1) / kDqRows;
  const int qb = blockIdx.x / n_half;
  const int row0 = (blockIdx.x % n_half) * kDqRows;
  const int rows = min(kDqRows, sc.bq - row0);  // a multiple of 16
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool live_warp = warp * 16 < rows;

  const size_t q_row0 = (size_t)bh * Sqp + (size_t)qb * sc.bq + row0;
  stage(qs, dp, q + q_row0 * d, kDqRows, rows, d, kDqThreads);
  stage(dos, dp, dout + q_row0 * d, kDqRows, rows, d, kDqThreads);
  for (int t = threadIdx.x; t < kDqRows; t += kDqThreads) {
    lse_s[t] = t < rows ? lse[q_row0 + t] : 0.0f;
    delta_s[t] = t < rows ? delta[q_row0 + t] : 0.0f;
  }

  const bf16* kg = k + (size_t)(bh / groups) * Skp * d;
  const bf16* vg = v + (size_t)(bh / groups) * Skp * d;
  const bf16* q_w = qs + warp * 16 * dp;
  const bf16* do_w = dos + warp * 16 * dp;
  bf16* ds_w = dss + warp * 16 * sp;
  float* s_t = tiles + warp * 512;
  float* dp_t = s_t + 256;

  Frag acc[kMaxD / 16];
#pragma unroll
  for (int i = 0; i < kMaxD / 16; ++i) wmma::fill_fragment(acc[i], 0.0f);

  const int count = kv_cnt[qb];
  for (int step = 0; step < count; ++step) {
    const int kb = kv_idx[qb * width + step];
    __syncthreads();  // the previous K/V tiles are consumed
    stage(ks, dp, kg + (size_t)kb * sc.bk * d, sc.bk, sc.bk, d, kDqThreads);
    stage(vs, dp, vg + (size_t)kb * sc.bk * d, sc.bk, sc.bk, d, kDqThreads);
    __syncthreads();
    if (!live_warp) continue;

    for (int nt = 0; nt < sc.bk / 16; ++nt) {
      rows_dot(s_t, q_w, ks + nt * 16 * dp, dp, d);    // q @ k^T
      rows_dot(dp_t, do_w, vs + nt * 16 * dp, dp, d);  // do @ v^T
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = warp * 16 + e / 16, c = nt * 16 + e % 16;
        float p, ds;
        sc(s_t[e], dp_t[e], lse_s[r], delta_s[r],
           sc.q_offset + qb * sc.bq + row0 + r, kb * sc.bk + c, p, ds);
        ds_w[(e / 16) * sp + c] = __float2bfloat16(ds);
      }
      __syncwarp();
    }
    acc_product(acc, ds_w, sp, ks, dp, sc.bk, d);  // dq += ds @ k
  }

  if (!live_warp) return;
  store_rows(dq + (q_row0 + warp * 16) * d, acc, s_t, d);
}

// ---------------------------------------------------------------- K11: dk, dv

constexpr int kKvWarps = 8;
constexpr int kKvThreads = kKvWarps * 32;

__host__ __device__ inline size_t dkv_smem(int d, int bq, int bk) {
  const size_t dp = d + 8, qp = bq + 8;
  return sizeof(bf16) * (2 * bk * dp + 2 * bq * dp + kKvWarps * 2 * 16 * qp) +
         sizeof(float) * (kKvWarps * 2 * 256 + 2 * bq);
}

__global__ void __launch_bounds__(kKvThreads)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ q_idx, const int* __restrict__ q_cnt,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int Sqp, int Skp,
                 int d, int q_width, int groups, Score sc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int dp = d + 8, qp = sc.bq + 8;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + sc.bk * dp;
  bf16* qs = vs + sc.bk * dp;
  bf16* dos = qs + sc.bq * dp;
  bf16* pts = dos + sc.bq * dp;               // per warp: p^T then ds^T, 16 x qp each
  float* tiles = reinterpret_cast<float*>(pts + kKvWarps * 2 * 16 * qp);
  float* lse_s = tiles + kKvWarps * 2 * 256;
  float* delta_s = lse_s + sc.bq;

  const int kb = blockIdx.x;
  const int b = blockIdx.y;  // row of the (B*KV, Skp, d) layout
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool live_warp = warp * 16 < sc.bk;

  const size_t kv_row0 = (size_t)b * Skp + (size_t)kb * sc.bk;
  stage(ks, dp, k + kv_row0 * d, sc.bk, sc.bk, d, kKvThreads);
  stage(vs, dp, v + kv_row0 * d, sc.bk, sc.bk, d, kKvThreads);

  const bf16* k_w = ks + warp * 16 * dp;
  const bf16* v_w = vs + warp * 16 * dp;
  bf16* pt_w = pts + warp * 2 * 16 * qp;
  bf16* dst_w = pt_w + 16 * qp;
  float* s_t = tiles + warp * 512;
  float* dp_t = s_t + 256;

  Frag dk_acc[kMaxD / 16], dv_acc[kMaxD / 16];
#pragma unroll
  for (int i = 0; i < kMaxD / 16; ++i) {
    wmma::fill_fragment(dk_acc[i], 0.0f);
    wmma::fill_fragment(dv_acc[i], 0.0f);
  }

  const int count = q_cnt[kb];
  for (int gm = 0; gm < groups; ++gm) {
    const size_t bh = (size_t)b * groups + gm;
    for (int step = 0; step < count; ++step) {
      const int qb = q_idx[kb * q_width + step];
      const size_t q_row0 = bh * Sqp + (size_t)qb * sc.bq;
      __syncthreads();  // the previous q/do tiles are consumed
      stage(qs, dp, q + q_row0 * d, sc.bq, sc.bq, d, kKvThreads);
      stage(dos, dp, dout + q_row0 * d, sc.bq, sc.bq, d, kKvThreads);
      for (int t = threadIdx.x; t < sc.bq; t += kKvThreads) {
        lse_s[t] = lse[q_row0 + t];
        delta_s[t] = delta[q_row0 + t];
      }
      __syncthreads();
      if (!live_warp) continue;

      for (int nt = 0; nt < sc.bq / 16; ++nt) {
        rows_dot(s_t, k_w, qs + nt * 16 * dp, dp, d);    // (q @ k^T)^T
        rows_dot(dp_t, v_w, dos + nt * 16 * dp, dp, d);  // (do @ v^T)^T
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = e / 16, c = nt * 16 + e % 16;
          float p, ds;
          sc(s_t[e], dp_t[e], lse_s[c], delta_s[c], sc.q_offset + qb * sc.bq + c,
             kb * sc.bk + warp * 16 + r, p, ds);
          pt_w[r * qp + c] = __float2bfloat16(p);
          dst_w[r * qp + c] = __float2bfloat16(ds);
        }
        __syncwarp();
      }
      acc_product(dv_acc, pt_w, qp, dos, dp, sc.bq, d);   // dv += p^T @ do
      acc_product(dk_acc, dst_w, qp, qs, dp, sc.bq, d);   // dk += ds^T @ q
    }
  }

  if (!live_warp) return;
  store_rows(dk + (kv_row0 + warp * 16) * d, dk_acc, s_t, d);
  store_rows(dv + (kv_row0 + warp * 16) * d, dv_acc, s_t, d);
}

}  // namespace

// q, do (BH, Sqp, d), k, v (BH/groups, Skp, d) bf16; lse, delta (BH, Sqp)
// f32; kv_idx (Sqp/bq, width), kv_cnt (Sqp/bq,) int32; dq (BH, Sqp, d)
// bf16.  The wrapper checks d % 16 == 0 and d <= 128, bq and bk multiples of
// 16 up to 128, Sqp % bq == 0, Skp % bk == 0 and 16-byte alignment.
extern "C" int flash_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, const void* kv_idx,
                        const void* kv_cnt, void* dq, int BH, int Sqp, int Skp, int d,
                        int bq, int bk, int width, int groups, int causal, int window,
                        int q_offset, int sk, float scale, float softcap, void* stream) {
  const size_t smem = dq_smem(d, bk);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Score sc{bq, bk, causal, window, q_offset, sk, scale, softcap};
  const int n_half = (bq + kDqRows - 1) / kDqRows;
  const dim3 grid((Sqp / bq) * n_half, BH);
  flash_dq_kernel<<<grid, kDqThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_idx), static_cast<const int*>(kv_cnt),
      static_cast<bf16*>(dq), Sqp, Skp, d, width, groups, sc);
  return static_cast<int>(cudaGetLastError());
}

// Same layouts; q_idx (Skp/bk, q_width), q_cnt (Skp/bk,) int32 (the
// transposed schedule); dk, dv (BH/groups, Skp, d) bf16.
extern "C" int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, const void* q_idx,
                         const void* q_cnt, void* dk, void* dv, int BH, int Sqp,
                         int Skp, int d, int bq, int bk, int q_width, int groups,
                         int causal, int window, int q_offset, int sk, float scale,
                         float softcap, void* stream) {
  const size_t smem = dkv_smem(d, bq, bk);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Score sc{bq, bk, causal, window, q_offset, sk, scale, softcap};
  const dim3 grid(Skp / bk, BH / groups);
  flash_dkv_kernel<<<grid, kKvThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(q_idx), static_cast<const int*>(q_cnt),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sqp, Skp, d, q_width, groups, sc);
  return static_cast<int>(cudaGetLastError());
}
