// Stage knock-outs of decode attention over the pos-major packed cache:
// probe P11.
//
// P11 replaces tools/aprobe.py run_variant / variant_kernel, the stage
//    knock-outs of llm_mixed_q_tpu/kernels/attention_decode.py
//    _attn_kernel_batch. It is a copy of K4 (csrc/attention_decode.cu,
//    attn_decode_kernel read with the pos-major strides) with stages
//    knocked out; K4 itself is untouched. Cache arrays are
//    [b, rows, S*nkv] with lane = pos*nkv + head, K and V both [hd, lanes].
//
// One block per (kv head, batch element), as K4, for its rep query rows.
// Each stage computes what aprobe.variant_kernel computes:
//   dma      reads the K and V codes and scales of the head's filled
//            positions with K4's loads and returns q;
//   dequant  also dequantizes them; returns q;
//   matmul   scores = q . deq(K) / sqrt(hd) over EVERY lane of the cache
//            (all heads, all S positions: the TPU kernel's dense product,
//            taken before its mask) and ctx = scores . deq(V) over every
//            lane: nkv times the dot work of K4, on K and V the block reads
//            whole;
//   softmax  scores over the head's filled positions, float32 softmax (the
//            denominator summed in float64, as K4), ctx = P . deq(V);
//   quant    also block_fp-quantizes P over [1, bs] runs of the head's
//            positions: K4's arithmetic.
// Dots in float32, or on bf16 operands (q and the scores or probabilities
// rounded to bf16; deq(K) and deq(V) are exact in bf16), summed in float32
// on the CUDA cores as K4 sums: the bf16 rows measure the rounding, not a
// tensor-core rate.
//
// What bounds it on an H100: as K4, the cache bytes of the filled positions
// over the 3.35 TB/s memory rate; the matmul stage also the float32 rate of
// its dense dots.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../bfp_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRepMax = 8;
constexpr int kDimBatch = 16;  // K dims a thread loads at once (hd % 16 == 0)
constexpr int kPosBatch = 8;   // V positions a thread loads at once
constexpr int kSmemMax = 227 * 1024;

enum Stage { kDma = 0, kDequant, kMatmul, kSoftmax, kQuant };

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int ST, bool BF16>
__global__ void __launch_bounds__(kThreads)
attn_probe_kernel(const float* __restrict__ q, const int8_t* __restrict__ kc,
                  const float* __restrict__ ks, const int8_t* __restrict__ vc,
                  const float* __restrict__ vs, const int* __restrict__ positions,
                  float* __restrict__ out, int nkv, int rep, int hd, int S, int bs_k,
                  int bs_v, float sqrt_hd, lmq::BfpSpec pq) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const long long lanes = (long long)S * nkv;
  const int npos = min(positions[b], S - 1) + 1;
  // the columns of the dots: the head's filled positions (lane p*nkv + h),
  // or every lane of the cache (matmul)
  const int ncol = ST == kMatmul ? (int)lanes : npos;
  const int cstride = ST == kMatmul ? 1 : nkv;
  const int cbase = ST == kMatmul ? 0 : h;
  float* qs = smem;              // [rep][hd]
  float* sc = qs + rep * hd;     // [rep][ncol]: scores, then probabilities
  float* part = sc + rep * ncol;  // [rep][parts][hd], parts * hd == kThreads

  const size_t row0 = ((size_t)b * nkv + h) * rep;  // first query row
  for (int i = tid; i < rep * hd; i += kThreads)
    qs[i] = BF16 ? bf16_round(q[row0 * hd + i]) : q[row0 * hd + i];
  __syncthreads();

  uint32_t sink = 0;  // dma: bits of what was read
  float dsum = 0.f;   // dequant: sum of what was dequantized

  // scores: one thread per column, 16 dims of K loaded at once
  const int8_t* kcb = kc + (size_t)b * hd * lanes + cbase;
  const float* ksb = ks + (size_t)b * (hd / bs_k) * lanes + cbase;
  for (int p = tid; p < ncol; p += kThreads) {
    const long long col = (long long)p * cstride;
    float acc[kRepMax];
#pragma unroll
    for (int r = 0; r < kRepMax; ++r) acc[r] = 0.f;
    for (int d0 = 0; d0 < hd; d0 += kDimBatch) {
      float kv[kDimBatch];
      if constexpr (ST == kDma) {
        if (bs_k % kDimBatch == 0) {
          sink += __float_as_uint(ksb[(d0 / bs_k) * lanes + col]);
#pragma unroll
          for (int dd = 0; dd < kDimBatch; ++dd) sink += (uint8_t)kcb[(d0 + dd) * lanes + col];
        } else {
#pragma unroll
          for (int dd = 0; dd < kDimBatch; ++dd) {
            const int d = d0 + dd;
            sink += (uint8_t)kcb[d * lanes + col] + __float_as_uint(ksb[(d / bs_k) * lanes + col]);
          }
        }
        continue;
      }
      if (bs_k % kDimBatch == 0) {  // one scale for the 16 dims
        const float s = ksb[(d0 / bs_k) * lanes + col];
#pragma unroll
        for (int dd = 0; dd < kDimBatch; ++dd) kv[dd] = (float)kcb[(d0 + dd) * lanes + col] * s;
      } else {
#pragma unroll
        for (int dd = 0; dd < kDimBatch; ++dd) {
          const int d = d0 + dd;
          kv[dd] = (float)kcb[d * lanes + col] * ksb[(d / bs_k) * lanes + col];
        }
      }
      if constexpr (ST == kDequant) {
#pragma unroll
        for (int dd = 0; dd < kDimBatch; ++dd) dsum += kv[dd];
      } else {
#pragma unroll
        for (int dd = 0; dd < kDimBatch; ++dd) {
#pragma unroll
          for (int r = 0; r < kRepMax; ++r)
            if (r < rep) acc[r] = fmaf(qs[r * hd + d0 + dd], kv[dd], acc[r]);
        }
      }
    }
    if constexpr (ST >= kMatmul) {
#pragma unroll
      for (int r = 0; r < kRepMax; ++r) {
        if (r < rep) {
          const float v = __fdiv_rn(acc[r], sqrt_hd);
          sc[r * ncol + p] = BF16 && ST == kMatmul ? bf16_round(v) : v;
        }
      }
    }
  }
  __syncthreads();

  if constexpr (ST >= kSoftmax) {
    // softmax: one warp per query row
    const int warp = tid / 32, lane = tid % 32;
    if (warp < rep) {
      float* row = sc + warp * ncol;
      float m = __int_as_float(0xff800000);  // -inf
      for (int p = lane; p < ncol; p += 32) m = fmaxf(m, row[p]);
      m = warp_max(m);
      double sum = 0.0;
      for (int p = lane; p < ncol; p += 32) {
        const float e = expf(__fsub_rn(row[p], m));
        row[p] = e;
        sum += (double)e;
      }
      const float denom = (float)warp_sum(sum);
      for (int p = lane; p < ncol; p += 32) row[p] = __fdiv_rn(row[p], denom);
    }
    __syncthreads();
  }
  if constexpr (ST == kQuant) {
    // block_fp quantization of the probabilities: one thread per block
    const int nblk = (ncol + pq.bs - 1) / pq.bs;
    for (int task = tid; task < rep * nblk; task += kThreads) {
      float* blk = sc + (task / nblk) * ncol + (task % nblk) * pq.bs;
      const int len = min(pq.bs, ncol - (task % nblk) * pq.bs);
      float mx = 0.f;
      for (int i = 0; i < len; ++i) mx = fmaxf(mx, blk[i]);
      for (int i = 0; i < len; ++i) blk[i] = lmq::bfp_qdq(blk[i], mx, pq);
    }
    __syncthreads();
  }
  if constexpr (BF16 && ST >= kSoftmax) {
    for (int i = tid; i < rep * ncol; i += kThreads) sc[i] = bf16_round(sc[i]);
    __syncthreads();
  }

  // ctx = P . deq(V): thread (part, d) sums columns part, part + parts, ...
  const int parts = kThreads / hd;
  const int d = tid % hd, pt = tid / hd;
  const int8_t* vcb = vc + (size_t)b * hd * lanes + d * lanes + cbase;
  const float* vsb = vs + (size_t)b * (hd / bs_v) * lanes + (d / bs_v) * lanes + cbase;
  float acc[kRepMax];
#pragma unroll
  for (int r = 0; r < kRepMax; ++r) acc[r] = 0.f;
  for (int p0 = pt; p0 < ncol; p0 += kPosBatch * parts) {  // kPosBatch loads at once
    float v[kPosBatch];
#pragma unroll
    for (int u = 0; u < kPosBatch; ++u) {
      const int p = p0 + u * parts;
      const long long col = (long long)p * cstride;
      if constexpr (ST == kDma) {
        if (p < ncol) sink += (uint8_t)vcb[col] + __float_as_uint(vsb[col]);
      } else {
        v[u] = p < ncol ? (float)vcb[col] * vsb[col] : 0.f;
      }
    }
    if constexpr (ST == kDequant) {
#pragma unroll
      for (int u = 0; u < kPosBatch; ++u) dsum += v[u];
    } else if constexpr (ST >= kMatmul) {
#pragma unroll
      for (int u = 0; u < kPosBatch; ++u) {
        const int p = p0 + u * parts;
        if (p >= ncol) break;
#pragma unroll
        for (int r = 0; r < kRepMax; ++r)
          if (r < rep) acc[r] = fmaf(sc[r * ncol + p], v[u], acc[r]);
      }
    }
  }

  if constexpr (ST <= kDequant) {
    // q, exactly; the barrier's predicate keeps every load (and, for
    // dequant, every product) alive
    const int any = __syncthreads_or(ST == kDma ? (int)(sink & 1u) : (int)(__float_as_uint(dsum) & 1u));
    if (pt == 0) {
      for (int r = 0; r < rep; ++r) out[(row0 + r) * hd + d] = qs[r * hd + d] + 0.f * (float)any;
    }
    return;
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

template <int ST, bool BF16>
int launch(const void* q, const void* kc, const void* ks, const void* vc, const void* vs,
           const void* positions, void* out, int b, int nkv, int rep, int hd, int S,
           int bs_k, int bs_v, float sqrt_hd, lmq::BfpSpec pq, cudaStream_t stream) {
  const long long ncol_max = ST == kMatmul ? (long long)S * nkv : S;
  const long long smem = 4 * (rep * hd + rep * ncol_max + rep * kThreads);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_probe_kernel<ST, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  attn_probe_kernel<ST, BF16><<<dim3(nkv, b), kThreads, (int)smem, stream>>>(
      (const float*)q, (const int8_t*)kc, (const float*)ks, (const int8_t*)vc,
      (const float*)vs, (const int*)positions, (float*)out, nkv, rep, hd, S, bs_k, bs_v,
      sqrt_hd, pq);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// stage: 0 dma, 1 dequant, 2 matmul, 3 softmax, 4 quant; bf16: dots on bf16
// operands (matmul, softmax, quant only)
int lmq_probe_attention(const void* q, const void* kc, const void* ks, const void* vc,
                        const void* vs, const void* positions, void* out, int b, int nkv,
                        int rep, int hd, int S, int bs_k, int bs_v, float sqrt_hd, int pq_on,
                        int pq_bs, int pq_width, int pq_emin, int pq_emax, int stage,
                        int bf16, void* stream) {
  if (rep < 1 || rep > kRepMax || hd > kThreads || kThreads % hd || hd % kDimBatch ||
      hd % bs_k || hd % bs_v || (stage == kQuant && (!pq_on || pq_bs < 1)))
    return (int)cudaErrorInvalidValue;
  const lmq::BfpSpec pq{pq_on, pq_bs, pq_width, pq_emin, pq_emax};
  auto s = static_cast<cudaStream_t>(stream);
#define LMQ_PROBE_CASE(ST, BF)                                                             \
  case ST * 2 + BF:                                                                        \
    return launch<ST, BF>(q, kc, ks, vc, vs, positions, out, b, nkv, rep, hd, S, bs_k, bs_v, \
                          sqrt_hd, pq, s);
  switch (stage * 2 + (bf16 ? 1 : 0)) {
    LMQ_PROBE_CASE(kDma, false)
    LMQ_PROBE_CASE(kDequant, false)
    LMQ_PROBE_CASE(kMatmul, false)
    LMQ_PROBE_CASE(kMatmul, true)
    LMQ_PROBE_CASE(kSoftmax, false)
    LMQ_PROBE_CASE(kSoftmax, true)
    LMQ_PROBE_CASE(kQuant, false)
    LMQ_PROBE_CASE(kQuant, true)
  }
#undef LMQ_PROBE_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
