// Flash-attention forward over a host-built AttnSchedule (online softmax).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_fwd_kernel
// (pallas_call in _fwd_call).  q (BH, Sqp, d), k/v (BH/G, Skp, d) bf16;
// query row bh reads KV row bh / G (GQA, no repeated K/V).  For q-block qb
// the kernel walks exactly kv_idx[qb, :kv_cnt[qb]] (core/attn_sched.py) and
// never rebuilds the schedule.  Outputs o (BH, Sqp, d) bf16 and the per-row
// logsumexp lse (BH, Sqp) f32; a row with no live key gets o = 0 and
// lse = +1e30, as in the TPU kernel.
//
// Design: one CTA of 4 warps per (bh, 64-row half of a q-block); each warp
// owns 16 query rows.  Per live KV block the CTA stages K and V (bk x d) in
// shared memory; each warp computes its 16 x bk scores with bf16 wmma into
// f32, applies scale, the optional softcap c*tanh(s/c), and the mask
// (causal kpos <= qpos, window kpos > qpos - window, kpos < sk for the
// padded tail, qpos = q_offset + qb*bq + r), updates the running max and sum
// in f32 with p zeroed where masked (a fully masked row of a live block
// keeps l = 0), rounds p to bf16 as the TPU kernel does before p @ v, and
// accumulates p @ v into an f32 tile in shared memory that is rescaled by
// exp(m_prev - m_new) row by row.  The finish writes o = acc / max(l, 1e-30)
// and lse = l > 0 ? m + log(l) : 1e30.
//
// head_dim is a runtime parameter (a multiple of 16 up to 128; danube uses
// 80, which is not a power of two).  At bq = bk = 128 and d = 80 the tiles
// need ~129 KB of shared memory, so the q-block is split in halves and the
// kernel uses dynamic shared memory after cudaFuncSetAttribute.
//
// Bound on the H100: at prefill lengths the work is 4*d flops per live
// (q, k) pair, tensor-core bound; the bytes are q, k, v and o once.  This
// first version uses synchronous loads and wmma (no TMA, no wgmma, no
// warp specialisation); its time against the bound is in PERF.md.
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // query rows per CTA
constexpr float kNegInf = -1e30f;
constexpr float kEps = 1e-30f;

struct Smem {
  __nv_bfloat16 *q, *k, *v, *p;
  float *s, *o, *m, *l;
};

__host__ __device__ inline size_t smem_bytes(int d, int bk) {
  const size_t dp = d + 8, sp = bk + 8;
  return sizeof(__nv_bfloat16) * (kRows * dp + 2 * bk * dp + kRows * sp) +
         sizeof(float) * (kRows * sp + kRows * dp + 2 * kRows);
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ kv_idx, const int* __restrict__ kv_cnt,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int Sqp, int Skp, int d, int bq, int bk, int width, int groups,
                 int causal, int window, int q_offset, int sk, float scale,
                 float softcap) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int dp = d + 8, sp = bk + 8;
  Smem sm;
  sm.q = reinterpret_cast<__nv_bfloat16*>(smem);
  sm.k = sm.q + kRows * dp;
  sm.v = sm.k + bk * dp;
  sm.p = sm.v + bk * dp;
  sm.s = reinterpret_cast<float*>(sm.p + kRows * sp);
  sm.o = sm.s + kRows * sp;
  sm.m = sm.o + kRows * dp;
  sm.l = sm.m + kRows;

  const int n_half = (bq + kRows - 1) / kRows;
  const int qb = blockIdx.x / n_half;
  const int row0 = (blockIdx.x % n_half) * kRows;  // first row inside the q-block
  const int rows = min(kRows, bq - row0);          // a multiple of 16
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool live_warp = warp * 16 < rows;
  const int dv8 = d / 8;

  const size_t q_row0 = (size_t)bh * Sqp + (size_t)qb * bq + row0;
  for (int t = threadIdx.x; t < kRows * dv8; t += kThreads) {
    const int r = t / dv8, c = (t % dv8) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < rows) val = *reinterpret_cast<const uint4*>(q + (q_row0 + r) * d + c);
    *reinterpret_cast<uint4*>(sm.q + r * dp + c) = val;
  }
  for (int t = threadIdx.x; t < kRows * dp; t += kThreads) sm.o[t] = 0.0f;
  for (int t = threadIdx.x; t < kRows; t += kThreads) {
    sm.m[t] = kNegInf;
    sm.l[t] = 0.0f;
  }
  __syncthreads();

  const __nv_bfloat16* kg = k + (size_t)(bh / groups) * Skp * d;
  const __nv_bfloat16* vg = v + (size_t)(bh / groups) * Skp * d;
  float* s_w = sm.s + warp * 16 * sp;
  __nv_bfloat16* p_w = sm.p + warp * 16 * sp;
  float* o_w = sm.o + warp * 16 * dp;
  const __nv_bfloat16* q_w = sm.q + warp * 16 * dp;
  const int count = kv_cnt[qb];

  for (int step = 0; step < count; ++step) {
    const int kb = kv_idx[qb * width + step];
    __syncthreads();  // the previous K/V tiles are consumed
    for (int t = threadIdx.x; t < bk * dv8; t += kThreads) {
      const int r = t / dv8, c = (t % dv8) * 8;
      const size_t g = ((size_t)kb * bk + r) * d + c;
      *reinterpret_cast<uint4*>(sm.k + r * dp + c) = *reinterpret_cast<const uint4*>(kg + g);
      *reinterpret_cast<uint4*>(sm.v + r * dp + c) = *reinterpret_cast<const uint4*>(vg + g);
    }
    __syncthreads();
    if (!live_warp) continue;

    // scores: (16 x d) @ (d x bk), K read as a column-major d x bk matrix
    for (int nt = 0; nt < bk / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kt = 0; kt < d / 16; ++kt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(a, q_w + kt * 16, dp);
        wmma::load_matrix_sync(b, sm.k + nt * 16 * dp + kt * 16, dp);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(s_w + nt * 16, acc, sp, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax, one row at a time; lanes split the bk <= 128 columns
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      const int qpos = q_offset + qb * bq + row0 + row;
      float vals[4];
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = lane + 32 * i;
        ok[i] = false;
        vals[i] = kNegInf;
        if (c < bk) {
          const int kpos = kb * bk + c;
          float sv = s_w[r * sp + c] * scale;
          if (softcap != 0.0f) sv = softcap * tanhf(sv / softcap);
          ok[i] = kpos < sk && (!causal || kpos <= qpos) &&
                  (!window || kpos > qpos - window);
          vals[i] = ok[i] ? sv : kNegInf;
          mx = fmaxf(mx, vals[i]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sm.m[row];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = lane + 32 * i;
        if (c < bk) {
          const float p = ok[i] ? expf(vals[i] - m_new) : 0.0f;
          p_w[r * sp + c] = __float2bfloat16(p);
          sum += p;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m_prev - m_new);
      __syncwarp();  // every lane has read m_prev
      if (lane == 0) {
        sm.m[row] = m_new;
        sm.l[row] = sm.l[row] * corr + sum;
      }
      for (int c = lane; c < d; c += 32) o_w[r * dp + c] *= corr;
    }
    __syncwarp();

    // o += p (16 x bk, bf16) @ v (bk x d)
    for (int nt = 0; nt < d / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, o_w + nt * 16, dp, wmma::mem_row_major);
      for (int kt = 0; kt < bk / 16; ++kt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, p_w + kt * 16, sp);
        wmma::load_matrix_sync(b, sm.v + kt * 16 * dp + nt * 16, dp);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(o_w + nt * 16, acc, dp, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (!live_warp) return;
  for (int r = 0; r < 16; ++r) {
    const int row = warp * 16 + r;
    const float l_raw = sm.l[row];
    const float l = fmaxf(l_raw, kEps);
    const size_t g = q_row0 + row;
    for (int c = lane; c < d; c += 32)
      o[g * d + c] = __float2bfloat16(o_w[r * dp + c] / l);
    if (lane == 0) lse[g] = l_raw > 0.0f ? sm.m[row] + logf(l) : -kNegInf;
  }
}

}  // namespace

// q (BH, Sqp, d), k/v (BH/groups, Skp, d) bf16; kv_idx (Sqp/bq, width),
// kv_cnt (Sqp/bq,) int32; o (BH, Sqp, d) bf16, lse (BH, Sqp) f32.  The
// wrapper checks d % 16 == 0 and d <= 128, bq and bk multiples of 16 up to
// 128, Sqp % bq == 0, Skp % bk == 0 and 16-byte alignment.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* kv_idx, const void* kv_cnt, void* o, void* lse,
                         int BH, int Sqp, int Skp, int d, int bq, int bk, int width,
                         int groups, int causal, int window, int q_offset, int sk,
                         float scale, float softcap, void* stream) {
  const size_t smem = smem_bytes(d, bk);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_half = (bq + kRows - 1) / kRows;
  const dim3 grid((Sqp / bq) * n_half, BH);
  flash_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(kv_idx),
      static_cast<const int*>(kv_cnt), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), Sqp, Skp, d, bq, bk, width, groups, causal, window,
      q_offset, sk, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}
