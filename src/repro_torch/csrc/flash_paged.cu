// Paged-prefix flash attention: the prefix phase of a suffix-only prefill.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_paged_kernel
// (pallas_call in _paged_call).  Suffix queries q (B, H, Sq, d) bf16 attend
// the first ctx[b] keys of a paged KV pool pk/pv (N, bs, KV, d) bf16, whose
// logical page j of row b is physical page table[b, j] (table (B, T) int32,
// unowned entries hold the sentinel N; reads clamp it to N - 1, as the TPU
// kernel's index map does, though no live key lies on one).  Key kpos is
// live iff kpos < min(ctx[b], T * bs); there is no causal mask, because
// every prefix key precedes every suffix query.  Scores are q.k * scale,
// then the optional softcap c*tanh(s/c).  Outputs o (B, H, Sq, d) bf16 and
// the row logsumexp lse (B, H, Sq) f32; a row with no live key gets o = 0
// and lse = -1e30 (not the forward kernel's +1e30: the logsumexp merge with
// the causal self phase needs exp(lse - m) to underflow to exactly 0).
//
// Design: GQA is folded into the rows.  The G = H / KV query heads of one
// KV head are adjacent in q, so for (b, kv) the G * Sq rows
// q[b, kv*G : (kv+1)*G] are one contiguous (G*Sq, d) matrix that attends
// one key sequence (the mask depends on b alone).  One CTA of 4 warps takes
// 64 of those rows (each warp 16) for one (b, kv): K and V of the KV head
// are read once per 64 rows rather than once per head.  The CTA walks only
// the ceil(n_keys / 128) live key tiles, reading ctx and the table on the
// device (no host sync); per tile, each of 128 threads resolves one key row
// through the table to its pool offset, then the CTA gathers the 8 pages of
// 16 keys (any bs works: a key row is d contiguous bf16 at
// ((page * bs + kpos % bs) * KV + kv) * d) into one shared-memory K/V tile,
// zero-filling keys at or past n_keys.  The pool is read at its own
// (N, bs, KV, d) strides: nothing is transposed or copied per call.  Scores,
// the online softmax (f32, p zeroed where masked, p rounded to bf16 before
// p @ v as the TPU kernel does) and the f32 accumulator follow
// csrc/flash_fwd.cu (K9), with wmma 16x16x16 bf16 tiles.
//
// Bound on the H100: the bytes are q and o once and the live K/V pages once
// per KV head; the work is 4*d flops per (query, live key) pair.  At a
// serving suffix (Sq 8-16, ctx 512) the grid has 16-24 CTAs and latency
// bounds it; at Sq = 128 the tensor cores.  This first version loads
// synchronously (no cp.async/TMA, no wgmma, no split over the key walk);
// its times against the bound are in PERF.md.
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // folded query rows per CTA
constexpr int kKeys = 128;          // keys per shared-memory tile
constexpr float kNegInf = -1e30f;
constexpr float kEps = 1e-30f;

__host__ __device__ inline size_t smem_bytes(int d) {
  const size_t dp = d + 8, sp = kKeys + 8;
  return sizeof(long long) * kKeys +
         sizeof(__nv_bfloat16) * (kRows * dp + 2 * kKeys * dp + kRows * sp) +
         sizeof(float) * (kRows * sp + kRows * dp + 2 * kRows);
}

__global__ void __launch_bounds__(kThreads)
flash_paged_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ pk,
                   const __nv_bfloat16* __restrict__ pv,
                   const int* __restrict__ table, const int* __restrict__ ctx,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int R, int N, int bs, int KV, int T, int d, float scale,
                   float softcap) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int dp = d + 8, sp = kKeys + 8;
  long long* key_off = reinterpret_cast<long long*>(smem);
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(key_off + kKeys);
  __nv_bfloat16* sk = sq + kRows * dp;
  __nv_bfloat16* sv = sk + kKeys * dp;
  __nv_bfloat16* spb = sv + kKeys * dp;
  float* ss = reinterpret_cast<float*>(spb + kRows * sp);
  float* so = ss + kRows * sp;
  float* sm_m = so + kRows * dp;
  float* sm_l = sm_m + kRows;

  const int bkv = blockIdx.y;  // b * KV + kv
  const int b = bkv / KV, kv = bkv % KV;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, R - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool live_warp = warp * 16 < rows;
  const int dv8 = d / 8;

  const size_t q_row0 = (size_t)bkv * R + row0;
  for (int t = threadIdx.x; t < kRows * dv8; t += kThreads) {
    const int r = t / dv8, c = (t % dv8) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < rows) val = *reinterpret_cast<const uint4*>(q + (q_row0 + r) * d + c);
    *reinterpret_cast<uint4*>(sq + r * dp + c) = val;
  }
  for (int t = threadIdx.x; t < kRows * dp; t += kThreads) so[t] = 0.0f;
  for (int t = threadIdx.x; t < kRows; t += kThreads) {
    sm_m[t] = kNegInf;
    sm_l[t] = 0.0f;
  }

  const int n_keys = min(ctx[b], T * bs);
  const int n_tiles = n_keys > 0 ? (n_keys + kKeys - 1) / kKeys : 0;
  float* s_w = ss + warp * 16 * sp;
  __nv_bfloat16* p_w = spb + warp * 16 * sp;
  float* o_w = so + warp * 16 * dp;
  const __nv_bfloat16* q_w = sq + warp * 16 * dp;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kKeys;
    __syncthreads();  // the previous K/V tiles are consumed
    for (int c = threadIdx.x; c < kKeys; c += kThreads) {
      const int kpos = k0 + c;
      long long off = -1;
      if (kpos < n_keys) {
        int page = table[(size_t)b * T + kpos / bs];
        page = min(max(page, 0), N - 1);
        off = (((long long)page * bs + kpos % bs) * KV + kv) * d;
      }
      key_off[c] = off;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < kKeys * dv8; t += kThreads) {
      const int r = t / dv8, c = (t % dv8) * 8;
      const long long off = key_off[r];
      uint4 kval = make_uint4(0, 0, 0, 0), vval = make_uint4(0, 0, 0, 0);
      if (off >= 0) {
        kval = *reinterpret_cast<const uint4*>(pk + off + c);
        vval = *reinterpret_cast<const uint4*>(pv + off + c);
      }
      *reinterpret_cast<uint4*>(sk + r * dp + c) = kval;
      *reinterpret_cast<uint4*>(sv + r * dp + c) = vval;
    }
    __syncthreads();
    if (!live_warp) continue;

    // scores: (16 x d) @ (d x 128), K read as a column-major d x 128 matrix
    for (int nt = 0; nt < kKeys / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kt = 0; kt < d / 16; ++kt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
        wmma::load_matrix_sync(a, q_w + kt * 16, dp);
        wmma::load_matrix_sync(bf, sk + nt * 16 * dp + kt * 16, dp);
        wmma::mma_sync(acc, a, bf, acc);
      }
      wmma::store_matrix_sync(s_w + nt * 16, acc, sp, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax, one row at a time; lanes split the 128 columns
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      float vals[4];
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = lane + 32 * i;
        float sv_ = s_w[r * sp + c] * scale;
        if (softcap != 0.0f) sv_ = softcap * tanhf(sv_ / softcap);
        ok[i] = k0 + c < n_keys;
        vals[i] = ok[i] ? sv_ : kNegInf;
        mx = fmaxf(mx, vals[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sm_m[row];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = lane + 32 * i;
        const float p = ok[i] ? expf(vals[i] - m_new) : 0.0f;
        p_w[r * sp + c] = __float2bfloat16(p);
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m_prev - m_new);
      __syncwarp();  // every lane has read m_prev
      if (lane == 0) {
        sm_m[row] = m_new;
        sm_l[row] = sm_l[row] * corr + sum;
      }
      for (int c = lane; c < d; c += 32) o_w[r * dp + c] *= corr;
    }
    __syncwarp();

    // o += p (16 x 128, bf16) @ v (128 x d)
    for (int nt = 0; nt < d / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, o_w + nt * 16, dp, wmma::mem_row_major);
      for (int kt = 0; kt < kKeys / 16; ++kt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
        wmma::load_matrix_sync(a, p_w + kt * 16, sp);
        wmma::load_matrix_sync(bf, sv + kt * 16 * dp + nt * 16, dp);
        wmma::mma_sync(acc, a, bf, acc);
      }
      wmma::store_matrix_sync(o_w + nt * 16, acc, dp, wmma::mem_row_major);
    }
    __syncwarp();
  }

  __syncthreads();  // a CTA with no live tile reads the init of other warps
  if (!live_warp) return;
  for (int r = 0; r < 16; ++r) {
    const int row = warp * 16 + r;
    if (row >= rows) break;
    const float l_raw = sm_l[row];
    const float l = fmaxf(l_raw, kEps);
    const size_t g = q_row0 + row;
    for (int c = lane; c < d; c += 32)
      o[g * d + c] = __float2bfloat16(o_w[r * dp + c] / l);
    if (lane == 0) lse[g] = l_raw > 0.0f ? sm_m[row] + logf(l) : kNegInf;
  }
}

}  // namespace

// q (B, H, Sq, d), pool pk/pv (N, bs, KV, d) bf16; table (B, T), ctx (B,)
// int32; o (B, H, Sq, d) bf16, lse (B, H, Sq) f32.  The wrapper checks
// d % 16 == 0, d <= 128, H % KV == 0, contiguity and 16-byte alignment.
extern "C" int flash_paged(const void* q, const void* pk, const void* pv,
                           const void* table, const void* ctx, void* o, void* lse,
                           int B, int H, int Sq, int N, int bs, int KV, int T, int d,
                           float scale, float softcap, void* stream) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_paged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int R = (H / KV) * Sq;  // folded rows of one (b, kv)
  const dim3 grid((R + kRows - 1) / kRows, B * KV);
  flash_paged_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(pk),
      static_cast<const __nv_bfloat16*>(pv), static_cast<const int*>(table),
      static_cast<const int*>(ctx), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), R, N, bs, KV, T, d, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}
