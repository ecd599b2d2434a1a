// Stage knock-outs of decode attention over the pos-major packed cache:
// probes P11, P12 and P13.
//
// P11 replaces tools/aprobe.py run_variant / variant_kernel, the stage
//    knock-outs of llm_mixed_q_tpu/kernels/attention_decode.py
//    _attn_kernel_batch. It is a copy of K4's former design
//    (attn_decode_kernel of csrc/attention_decode.cu, which K5 keeps, read
//    with pos-major strides) with stages knocked out; its quant stage with
//    float32 dots is the anchor the other copies and the redesigned K4 are
//    held to. Cache arrays are
//    [b, rows, S*nkv] with lane = pos*nkv + head, K and V both [hd, lanes].
//
// One block per (kv head, batch element), as K4's former design, for its rep
// query rows.
// Each stage computes what aprobe.variant_kernel computes:
//   dma      reads the K and V codes and scales of the head's filled
//            positions with that design's loads and returns q;
//   dequant  also dequantizes them; returns q;
//   matmul   scores = q . deq(K) / sqrt(hd) over EVERY lane of the cache
//            (all heads, all S positions: the TPU kernel's dense product,
//            taken before its mask) and ctx = scores . deq(V) over every
//            lane: nkv times the dot work of K4, on K and V the block reads
//            whole;
//   softmax  scores over the head's filled positions, float32 softmax (the
//            denominator summed in float64, as K4 and K5), ctx = P . deq(V);
//   quant    also block_fp-quantizes P over [1, bs] runs of the head's
//            positions: the arithmetic of K4's former design.
// Dots in float32, or on bf16 operands (q and the scores or probabilities
// rounded to bf16; deq(K) and deq(V) are exact in bf16), summed in float32
// on the CUDA cores as K4 sums: the bf16 rows measure the rounding, not a
// tensor-core rate.
//
// P12 replaces tools/k3.py call_v2 / v2_kernel, P13 call_v3 / v3_kernel:
// the TPU's v2 batch kernel with stages knocked out and a v3 candidate.
// Both dot on bf16 operands. v2's dots, softmax and full stages compute
// what matmul, softmax and quant compute above with bf16 dots, and are
// those instances; three more stages:
//   qmax     softmax, then each probability replaced by the max over its
//            aligned run of bs positions of its head (the block max that
//            the TPU's butterfly leaves, with no exponent or mantissa
//            work); as on the TPU, whose context dot runs over every lane,
//            the positions after pos up to the end of pos's run (capped
//            at S) take that max too and add their V;
//   qmath    the prob quantizer's exponent/mantissa chain with each
//            probability as its own block max, at the tool's hard-coded
//            constants (exponent in [-127, 128], 5 mantissa bits, p kept
//            where p <= 1e-8);
//   masks    (P13) quant, with the own-head bias and the causal index
//            read from two resident arrays [nh, S*nkv] in global memory
//            (negb: 0 on a row's own-head lanes, -1e9 elsewhere; posi:
//            lane / nkv) at the lanes the block visits, instead of from
//            index arithmetic. They are the same for every batch
//            element, so after the first blocks they come from L2.
//
// What bounds it on an H100: as K4, the cache bytes of the filled positions
// over the 3.35 TB/s memory rate (masks: plus the mask bytes it reads);
// the matmul stage also the rate of its dense dots (float32 CUDA cores for
// float32 operands, bf16 tensor cores for bf16 ones).

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

enum Stage { kDma = 0, kDequant, kMatmul, kSoftmax, kQuant, kQmax, kQmath, kMasks };
constexpr float kMaskedScore = -1e9f;  // the TPU tool's NEG_INF

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

// Every stage is held to 4 blocks an SM (64 registers), the occupancy of
// K4's former design, whose time was the blocks that wait on their reads at
// once: P11's stages sit at 64 registers without the minimum (a minimum of 1 block an
// SM took them to 96, 2 blocks an SM, and 45% more time); qmax's longer V
// loop took 79 registers and 3 blocks an SM without it.
template <int ST, bool BF16>
__global__ void __launch_bounds__(kThreads, 4)
attn_probe_kernel(const float* __restrict__ q, const int8_t* __restrict__ kc,
                  const float* __restrict__ ks, const int8_t* __restrict__ vc,
                  const float* __restrict__ vs, const int* __restrict__ positions,
                  const float* __restrict__ negb, const int* __restrict__ posi,
                  float* __restrict__ out, int nkv, int rep, int hd, int S, int bs_k,
                  int bs_v, float sqrt_hd, lmq::BfpSpec pq) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const long long lanes = (long long)S * nkv;
  const int npos = min(positions[b], S - 1) + 1;
  // the columns of the scores: the head's filled positions (lane p*nkv + h),
  // or every lane of the cache (matmul); of the V dot: the same, or for
  // qmax up to the end of pos's run of pq.bs positions
  const int ncol = ST == kMatmul ? (int)lanes : npos;
  const int nv = ST == kQmax ? min((npos + pq.bs - 1) / pq.bs * pq.bs, S) : ncol;
  const int cstride = ST == kMatmul ? 1 : nkv;
  const int cbase = ST == kMatmul ? 0 : h;
  float* qs = smem;              // [rep][hd]
  float* sc = qs + rep * hd;     // [rep][nv]: scores, then probabilities
  float* part = sc + rep * nv;   // [rep][parts][hd], parts * hd == kThreads

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
          float v = __fdiv_rn(acc[r], sqrt_hd);
          if constexpr (ST == kMasks) {  // the resident masks at this lane
            const size_t m = (row0 - (size_t)b * nkv * rep + r) * lanes + cbase + col;
            v = __fadd_rn(v, negb[m]);
            if (posi[m] > positions[b]) v = kMaskedScore;
          }
          sc[r * nv + p] = BF16 && ST == kMatmul ? bf16_round(v) : v;
        }
      }
    }
  }
  __syncthreads();

  if constexpr (ST >= kSoftmax) {
    // softmax: one warp per query row
    const int warp = tid / 32, lane = tid % 32;
    if (warp < rep) {
      float* row = sc + warp * nv;
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
  if constexpr (ST == kQuant || ST == kMasks || ST == kQmax) {
    // one thread per block of pq.bs positions: block_fp quantization of the
    // probabilities, or (qmax) the block max over the filled positions,
    // written to every position of the block up to nv
    const int nblk = (nv + pq.bs - 1) / pq.bs;
    for (int task = tid; task < rep * nblk; task += kThreads) {
      float* blk = sc + (task / nblk) * nv + (task % nblk) * pq.bs;
      const int len = min(pq.bs, ncol - (task % nblk) * pq.bs);
      float mx = 0.f;
      for (int i = 0; i < len; ++i) mx = fmaxf(mx, blk[i]);
      if constexpr (ST == kQmax) {
        const int vlen = min(pq.bs, nv - (task % nblk) * pq.bs);
        for (int i = 0; i < vlen; ++i) blk[i] = mx;
      } else {
        for (int i = 0; i < len; ++i) blk[i] = lmq::bfp_qdq(blk[i], mx, pq);
      }
    }
    __syncthreads();
  }
  if constexpr (ST == kQmath) {
    // the exponent/mantissa chain, each probability its own block max
    const lmq::BfpSpec chain{1, 1, 6, -127, 128};
    for (int i = tid; i < rep * nv; i += kThreads) sc[i] = lmq::bfp_qdq(sc[i], sc[i], chain);
    __syncthreads();
  }
  if constexpr (BF16 && ST >= kSoftmax) {
    for (int i = tid; i < rep * nv; i += kThreads) sc[i] = bf16_round(sc[i]);
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
  for (int p0 = pt; p0 < nv; p0 += kPosBatch * parts) {  // kPosBatch loads at once
    float v[kPosBatch];
#pragma unroll
    for (int u = 0; u < kPosBatch; ++u) {
      const int p = p0 + u * parts;
      const long long col = (long long)p * cstride;
      if constexpr (ST == kDma) {
        if (p < nv) sink += (uint8_t)vcb[col] + __float_as_uint(vsb[col]);
      } else {
        v[u] = p < nv ? (float)vcb[col] * vsb[col] : 0.f;
      }
    }
    if constexpr (ST == kDequant) {
#pragma unroll
      for (int u = 0; u < kPosBatch; ++u) dsum += v[u];
    } else if constexpr (ST >= kMatmul) {
#pragma unroll
      for (int u = 0; u < kPosBatch; ++u) {
        const int p = p0 + u * parts;
        if (p >= nv) break;
#pragma unroll
        for (int r = 0; r < kRepMax; ++r)
          if (r < rep) acc[r] = fmaf(sc[r * nv + p], v[u], acc[r]);
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
           const void* positions, const void* negb, const void* posi, void* out, int b,
           int nkv, int rep, int hd, int S,
           int bs_k, int bs_v, float sqrt_hd, lmq::BfpSpec pq, cudaStream_t stream) {
  const long long ncol_max = ST == kMatmul ? (long long)S * nkv : S;
  const long long smem = 4 * (rep * hd + rep * ncol_max + rep * kThreads);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const auto kernel = attn_probe_kernel<ST, BF16>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(nkv, b), kThreads, (int)smem, stream>>>(
      (const float*)q, (const int8_t*)kc, (const float*)ks, (const int8_t*)vc,
      (const float*)vs, (const int*)positions, (const float*)negb, (const int*)posi,
      (float*)out, nkv, rep, hd, S, bs_k, bs_v, sqrt_hd, pq);
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
    return launch<ST, BF>(q, kc, ks, vc, vs, positions, nullptr, nullptr, out, b, nkv, rep,  \
                          hd, S, bs_k, bs_v, sqrt_hd, pq, s);
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

// P12 and P13, bf16 dots: stage 2 dots (matmul), 3 softmax, 4 full (quant),
// 5 qmax, 6 qmath, 7 masks (P13: quant with the resident masks negb and
// posi, each [nkv * rep, S * nkv]; null for the other stages)
int lmq_probe_attention_v2(const void* q, const void* kc, const void* ks, const void* vc,
                           const void* vs, const void* positions, const void* negb,
                           const void* posi, void* out, int b, int nkv, int rep, int hd, int S,
                           int bs_k, int bs_v, float sqrt_hd, int pq_on, int pq_bs,
                           int pq_width, int pq_emin, int pq_emax, int stage, void* stream) {
  const bool needs_pq = stage == kQuant || stage == kMasks;
  if (rep < 1 || rep > kRepMax || hd > kThreads || kThreads % hd || hd % kDimBatch ||
      hd % bs_k || hd % bs_v || (needs_pq && !pq_on) || pq_bs < 1 ||
      (stage == kMasks && (!negb || !posi)))
    return (int)cudaErrorInvalidValue;
  const lmq::BfpSpec pq{pq_on, pq_bs, pq_width, pq_emin, pq_emax};
  auto s = static_cast<cudaStream_t>(stream);
#define LMQ_PROBE_CASE(ST)                                                                  \
  case ST:                                                                                  \
    return launch<ST, true>(q, kc, ks, vc, vs, positions, negb, posi, out, b, nkv, rep, hd, \
                            S, bs_k, bs_v, sqrt_hd, pq, s);
  switch (stage) {
    LMQ_PROBE_CASE(kMatmul)
    LMQ_PROBE_CASE(kSoftmax)
    LMQ_PROBE_CASE(kQuant)
    LMQ_PROBE_CASE(kQmax)
    LMQ_PROBE_CASE(kQmath)
    LMQ_PROBE_CASE(kMasks)
  }
#undef LMQ_PROBE_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
