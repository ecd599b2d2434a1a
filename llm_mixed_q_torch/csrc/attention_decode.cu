// Decode attention over the packed KV cache: kernels K4 and K5.
//
// K4 replaces llm_mixed_q_tpu/kernels/attention_decode.py
//    packed_attention_decode_batch / _attn_kernel_batch (pos-major cache:
//    flat [b, rows, S*nkv] arrays, lane = pos*nkv + head, K and V both
//    [hd, lanes]).
// K5 replaces llm_mixed_q_tpu/kernels/attention_decode.py
//    packed_attention_decode / _attn_kernel (head-major cache: K codes
//    [b, nkv, hd, S], K scales [b, nkv, hd/bs, S], V codes [b, nkv, S, hd],
//    V scales [b, nkv, S, hd/bs]).
// Both are one device function read with two sets of strides.
//
// Per (batch element, kv head) block, for its rep query rows:
//   scores = q . deq(K) / sqrt(hd) over positions 0..positions[b] only;
//   float32 softmax with the denominator summed in float64 (see
//   kernels/attention_decode.py: kernel and plain version then agree on
//   every probability bit); block_fp quantization of the probabilities over
//   [1, bs] runs of positions, positions past positions[b] counting as
//   exactly 0 (as exp(-1e9 - m) = 0 makes them on the TPU);
//   ctx = P . deq(V), float32.
//
// What bounds it on an H100: the cache bytes (1 byte per code + 4/bs per
// scale, K and V) of the filled positions over the 3.35 TB/s memory rate;
// the work is ~4*hd flops per position and query row. Design: each block
// reads only its filled positions, once; the scores of all rep rows sit in
// shared memory (<= 8 x 4096 floats). A thread keeps 16 K loads (scores)
// or 8 V loads (P . V) in flight. In the head-major layout the loads of
// neighbouring positions (K) and dims (V) are coalesced; in the pos-major
// layout they stride by nkv bytes and lean on L2, since the blocks of the
// other heads read the same sectors. This is the simple first design.

#include <cstdint>
#include <cuda_runtime.h>

#include "bfp_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRepMax = 8;
constexpr int kDimBatch = 16;  // K dims a thread loads at once (hd % 16 == 0)
constexpr int kPosBatch = 8;   // V positions a thread loads at once
constexpr int kSmemMax = 227 * 1024;

// element strides of a cache array over (batch, kv head, inner, position);
// inner is the head dim (codes) or the scale block (scales)
struct Strides {
  long long b, h, i, p;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
attn_decode_kernel(const float* __restrict__ q, const int8_t* __restrict__ kc,
                   const float* __restrict__ ks, const int8_t* __restrict__ vc,
                   const float* __restrict__ vs, const int* __restrict__ positions,
                   float* __restrict__ out, int nkv, int rep, int hd, int S,
                   int bs_k, int bs_v, Strides kcs, Strides kss, Strides vcs,
                   Strides vss, float sqrt_hd, lmq::BfpSpec pq) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  float* qs = smem;              // [rep][hd]
  float* sc = qs + rep * hd;     // [rep][S]: scores, then probabilities
  float* part = sc + rep * S;    // [rep][parts][hd], parts * hd == kThreads
  const int npos = min(positions[b], S - 1) + 1;

  const size_t row0 = ((size_t)b * nkv + h) * rep;  // first query row
  for (int i = tid; i < rep * hd; i += kThreads) qs[i] = q[row0 * hd + i];
  __syncthreads();

  // scores: one thread per position, 16 dims of K loaded at once
  const int8_t* kcb = kc + b * kcs.b + h * kcs.h;
  const float* ksb = ks + b * kss.b + h * kss.h;
  for (int p = tid; p < npos; p += kThreads) {
    float acc[kRepMax];
#pragma unroll
    for (int r = 0; r < kRepMax; ++r) acc[r] = 0.f;
    for (int d0 = 0; d0 < hd; d0 += kDimBatch) {
      float kv[kDimBatch];
      if (bs_k % kDimBatch == 0) {  // one scale for the 16 dims
        const float s = ksb[(d0 / bs_k) * kss.i + p * kss.p];
#pragma unroll
        for (int dd = 0; dd < kDimBatch; ++dd)
          kv[dd] = (float)kcb[(d0 + dd) * kcs.i + p * kcs.p] * s;
      } else {
#pragma unroll
        for (int dd = 0; dd < kDimBatch; ++dd) {
          const int d = d0 + dd;
          kv[dd] = (float)kcb[d * kcs.i + p * kcs.p] * ksb[(d / bs_k) * kss.i + p * kss.p];
        }
      }
#pragma unroll
      for (int dd = 0; dd < kDimBatch; ++dd) {
#pragma unroll
        for (int r = 0; r < kRepMax; ++r)
          if (r < rep) acc[r] = fmaf(qs[r * hd + d0 + dd], kv[dd], acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRepMax; ++r)
      if (r < rep) sc[r * S + p] = __fdiv_rn(acc[r], sqrt_hd);
  }
  __syncthreads();

  // softmax: one warp per query row
  const int warp = tid / 32, lane = tid % 32;
  if (warp < rep) {
    float* row = sc + warp * S;
    float m = __int_as_float(0xff800000);  // -inf
    for (int p = lane; p < npos; p += 32) m = fmaxf(m, row[p]);
    m = warp_max(m);
    double sum = 0.0;
    for (int p = lane; p < npos; p += 32) {
      const float e = expf(__fsub_rn(row[p], m));
      row[p] = e;
      sum += (double)e;
    }
    const float denom = (float)warp_sum(sum);
    for (int p = lane; p < npos; p += 32) row[p] = __fdiv_rn(row[p], denom);
  }
  __syncthreads();

  // block_fp quantization of the probabilities: one thread per block
  if (pq.on) {
    const int nblk = (npos + pq.bs - 1) / pq.bs;
    for (int task = tid; task < rep * nblk; task += kThreads) {
      float* blk = sc + (task / nblk) * S + (task % nblk) * pq.bs;
      const int len = min(pq.bs, npos - (task % nblk) * pq.bs);
      float mx = 0.f;
      for (int i = 0; i < len; ++i) mx = fmaxf(mx, blk[i]);
      for (int i = 0; i < len; ++i) blk[i] = lmq::bfp_qdq(blk[i], mx, pq);
    }
    __syncthreads();
  }

  // ctx = P . deq(V): thread (part, d) sums positions part, part + parts, ...
  const int parts = kThreads / hd;
  const int d = tid % hd, pt = tid / hd;
  const int8_t* vcb = vc + b * vcs.b + h * vcs.h + d * vcs.i;
  const float* vsb = vs + b * vss.b + h * vss.h + (d / bs_v) * vss.i;
  float acc[kRepMax];
#pragma unroll
  for (int r = 0; r < kRepMax; ++r) acc[r] = 0.f;
  for (int p0 = pt; p0 < npos; p0 += kPosBatch * parts) {  // kPosBatch loads at once
    float v[kPosBatch];
#pragma unroll
    for (int u = 0; u < kPosBatch; ++u) {
      const int p = p0 + u * parts;
      v[u] = p < npos ? (float)vcb[p * vcs.p] * vsb[p * vss.p] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPosBatch; ++u) {
      const int p = p0 + u * parts;
      if (p >= npos) break;
#pragma unroll
      for (int r = 0; r < kRepMax; ++r)
        if (r < rep) acc[r] = fmaf(sc[r * S + p], v[u], acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRepMax; ++r)
    if (r < rep) part[(r * parts + pt) * hd + d] = acc[r];
  __syncthreads();
  if (pt == 0) {
    for (int r = 0; r < rep; ++r) {
      float s = 0.f;
      for (int k = 0; k < parts; ++k) s += part[(r * parts + k) * hd + d];
      out[(row0 + r) * hd + d] = s;
    }
  }
}

int launch(const void* q, const void* kc, const void* ks, const void* vc,
           const void* vs, const void* positions, void* out, int b, int nkv,
           int rep, int hd, int S, int bs_k, int bs_v, Strides kcs, Strides kss,
           Strides vcs, Strides vss, float sqrt_hd, lmq::BfpSpec pq,
           void* stream) {
  if (rep < 1 || rep > kRepMax || hd > kThreads || kThreads % hd || hd % kDimBatch ||
      hd % bs_k || hd % bs_v || (pq.on && pq.bs < 1))
    return (int)cudaErrorInvalidValue;
  const int smem = 4 * (rep * hd + rep * S + rep * kThreads);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  attn_decode_kernel<<<dim3(nkv, b), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      (const float*)q, (const int8_t*)kc, (const float*)ks, (const int8_t*)vc,
      (const float*)vs, (const int*)positions, (float*)out, nkv, rep, hd, S, bs_k,
      bs_v, kcs, kss, vcs, vss, sqrt_hd, pq);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4: pos-major cache, every array [b, rows, S*nkv] with lane = pos*nkv + head
int lmq_attn_decode_pos_major(const void* q, const void* kc, const void* ks,
                              const void* vc, const void* vs, const void* positions,
                              void* out, int b, int nkv, int rep, int hd, int S,
                              int bs_k, int bs_v, float sqrt_hd, int pq_on,
                              int pq_bs, int pq_width, int pq_emin, int pq_emax,
                              void* stream) {
  const long long lanes = (long long)S * nkv;
  const Strides kcs{hd * lanes, 1, lanes, nkv};
  const Strides kss{(hd / bs_k) * lanes, 1, lanes, nkv};
  const Strides vcs{hd * lanes, 1, lanes, nkv};
  const Strides vss{(hd / bs_v) * lanes, 1, lanes, nkv};
  return launch(q, kc, ks, vc, vs, positions, out, b, nkv, rep, hd, S, bs_k, bs_v,
                kcs, kss, vcs, vss, sqrt_hd,
                lmq::BfpSpec{pq_on, pq_bs, pq_width, pq_emin, pq_emax}, stream);
}

// K5: head-major cache, K [b, nkv, hd, S] / [b, nkv, hd/bs, S],
// V [b, nkv, S, hd] / [b, nkv, S, hd/bs]
int lmq_attn_decode_head_major(const void* q, const void* kc, const void* ks,
                               const void* vc, const void* vs, const void* positions,
                               void* out, int b, int nkv, int rep, int hd, int S,
                               int bs_k, int bs_v, float sqrt_hd, int pq_on,
                               int pq_bs, int pq_width, int pq_emin, int pq_emax,
                               void* stream) {
  const long long s = S;
  const Strides kcs{nkv * hd * s, hd * s, s, 1};
  const Strides kss{nkv * (hd / bs_k) * s, (hd / bs_k) * s, s, 1};
  const Strides vcs{nkv * s * hd, s * hd, 1, hd};
  const Strides vss{nkv * s * (hd / bs_v), s * (hd / bs_v), 1, hd / bs_v};
  return launch(q, kc, ks, vc, vs, positions, out, b, nkv, rep, hd, S, bs_k, bs_v,
                kcs, kss, vcs, vss, sqrt_hd,
                lmq::BfpSpec{pq_on, pq_bs, pq_width, pq_emin, pq_emax}, stream);
}

}  // extern "C"
