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
//
// Both compute, for each batch element and each query row of kv head h:
//   scores = q . deq(K) / sqrt(hd) over positions 0..positions[b] only;
//   float32 softmax with the denominator summed in float64 (see
//   kernels/attention_decode.py: kernel and plain version then agree on
//   every probability bit); block_fp quantization of the probabilities over
//   [1, bs] runs of positions, positions past positions[b] counting as
//   exactly 0 (as exp(-1e9 - m) = 0 makes them on the TPU);
//   ctx = P . deq(V), float32.
//
// What bounds them on an H100: the cache bytes (1 byte per code + 4/bs per
// scale, K and V) of the filled positions over the 3.35 TB/s memory rate;
// the work is ~4*hd flops per position and query row (0.4 to 3 flops a
// byte), far under the CUDA cores' rate.
//
// K4. In the pos-major layout the heads of a position are neighbours, so a
// block that owned one (batch element, head) pair read one byte of every
// 32-byte sector and left the rest to the other heads' blocks (the former
// design, which K5 keeps). K4 instead gives a block all kv heads (G of
// them; G < nkv only past 256 query rows) of a chunk of P positions of one
// batch element (P * G <= 512 lanes; 16 positions at 32 heads): each hd-row
// of its K and V tile is one contiguous run of P * G bytes, and its scale
// rows runs of P * G floats, staged with 16-byte cp.async copies (element
// copies where a run is off 16 bytes), so every sector of the cache is read
// by one block, once. The grid runs over (chunk, head group, batch element)
// (128 blocks at batch 8, 32 heads, S 256), and chunks past positions[b]
// exit at once (read on the device, no host sync). A block queues every
// tile of its K (or V) at once where the ring allows (up to 8 stages), a
// tile being all of hd (up to 128 dims) where two stages fit, else 64, 32
// or 16: a block's time went with its number of tiles, not with its bytes
// (PERF.md), and bulk (TMA) copies of the same runs were no faster than
// cp.async.
// A thread takes a quad of 4 neighbouring lanes (4 heads of a position
// where G % 4 == 0): one 4-byte load of codes, one 16-byte load of scales
// and, for each query row, one 16-byte load of q or of the probabilities
// serve 4 lanes; the threads split the dims (scores) or the positions
// (P . V) in groups that are summed in a fixed order; the query rows a
// head (rep) are a template parameter. The softmax and the prob quantizer
// need every row's max and denominator, so one C call launches four
// kernels on the stream:
//   k4_scores_kernel  scores of the chunk's lanes (q's tile rides in the
//                     ring) into a float32 workspace [b, nh, S];
//   k4_stats_kernel   per row, the max and the float64 denominator over
//                     the filled positions, summed in a fixed order, and
//                     the max of exp over each prob block longer than
//                     min(P, 32) (the division by the denominator is
//                     monotone, so it gives the block's max probability);
//   k4_pv_kernel      queues its V tiles first, then the chunk's
//                     probabilities, their block_fp quantization (a block
//                     of <= min(P, 32) positions by a shuffle of its
//                     lanes), and P . deq(V) of the chunk into a partial
//                     [b, chunk, hd, nh];
//   k4_sum_kernel     the partials of the filled chunks summed in chunk
//                     order.
// No atomics: a batch element's ctx does not depend on the others or on b.
// The workspace comes from the caller.
//
// K5: one block per (batch element, kv head), for its rep query rows; the
// scores of all rep rows sit in shared memory (<= 8 x 4096 floats). A
// thread keeps 16 K loads (scores) or 8 V loads (P . V) in flight; the
// loads of neighbouring positions (K) and dims (V) are coalesced.

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

// ---------------------------------------------------------------- K4

constexpr int kK4Threads = 256;
constexpr int kK4MaxDims = 128;   // head dims a ring stage, at most
constexpr int kK4Stages = 8;      // ring stages in flight, at most
constexpr int kK4Lanes = 512;     // lanes (positions x heads) a block, at most
constexpr int kK4Rows = 256;      // query rows (heads x rep) a block, at most

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most n (0 .. kK4Stages - 2) of this thread's copy groups
// are in flight
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::); break;
  }
}

// code j of a word of four int8 codes biased by 0x80 a byte, as float:
// 2^23 + (code + 128), built from bits, minus 2^23 + 128, exactly
__device__ __forceinline__ float k4_code(uint32_t biased, int j) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + j)) - 8388736.f;
}

// The shape of a K4 call and its block geometry (set by the host).
struct K4Shape {
  int b, nkv, rep, hd, S, L;  // L = S * nkv lanes
  int G, P, lP, nch;       // heads and positions (2^lP) a block; chunks of S
  int lbs_k, lbs_v;        // log2 of the K and V scale blocks
  int cstr, sstr, pstr;    // a stage's code row (bytes) and scale row (floats); a prob row
  int stages1, stage1_bytes, stages2, stage2_bytes;
  int dgs;                 // scores: dim groups of threads, a power of two <= 16
  int pgs;                 // P . V (G % 4 == 0): position groups of threads
  int nlb;                 // prob blocks of > min(P, 32) positions a row (0: none)
  int dims;                // head dims a ring stage: 64, 32 or 16
  int codes16, ks16, vs16;  // 16-byte copies for the codes and for the K and V scales
};

// The block's batch element, chunk and heads: positions p0 .. p0 + np - 1
// (np >= 1) of the npos filled ones, heads h0 .. h0 + gl - 1. False for a
// chunk past positions[b].
struct K4Block {
  int b, c, p0, np, h0, gl, npos;
};

__device__ __forceinline__ bool k4_block(const K4Shape& s, const int* positions, K4Block& k) {
  k.c = blockIdx.x;
  k.b = blockIdx.z;
  k.npos = min(positions[k.b], s.S - 1) + 1;
  k.p0 = k.c * s.P;
  if (k.p0 >= k.npos) return false;
  k.np = min(s.P, k.npos - k.p0);
  k.h0 = blockIdx.y * s.G;
  k.gl = min(s.G, s.nkv - k.h0);
  return true;
}

// Queue `rows` rows of the block's lanes of a cache array (row r at src +
// r * L elements) into dst (row r at dst + r * dstr bytes, lane (pp, hh) of
// the block at element pp * G + hh). With `vec`: 16-byte copies, of one run
// of the np * G lanes of a row where the block has every head (the run
// rounded up to 16 bytes, which stays inside the row), else of a run of gl
// lanes a position. Else an element at a time.
template <typename T>
__device__ __forceinline__ void k4_queue_rows(uint8_t* dst, int dstr, const T* src, int rows,
                                              const K4Shape& s, const K4Block& k, bool vec) {
  constexpr int U = 16 / sizeof(T);  // elements a 16-byte copy
  if (vec) {
    const bool whole = s.G == s.nkv;
    const int per_run = whole ? (k.np * s.G + U - 1) / U : k.gl / U;
    const int per_row = (whole ? 1 : k.np) * per_run;
    for (int i = threadIdx.x; i < rows * per_row; i += kK4Threads) {
      const int r = i / per_row, j = i % per_row, run = j / per_run, c = (j % per_run) * U;
      const long long lane = (long long)(k.p0 + run) * s.nkv + k.h0 + c;
      cp_async16(dst + r * dstr + (run * s.G + c) * (int)sizeof(T), src + r * (long long)s.L + lane);
    }
  } else {
    const int per_row = k.np * k.gl;
    for (int i = threadIdx.x; i < rows * per_row; i += kK4Threads) {
      const int r = i / per_row, j = i % per_row, pp = j / k.gl, hh = j % k.gl;
      const long long lane = (long long)(k.p0 + pp) * s.nkv + k.h0 + hh;
      T* d = reinterpret_cast<T*>(dst + r * dstr) + pp * s.G + hh;
      if constexpr (sizeof(T) == 4)
        cp_async4(d, src + r * (long long)s.L + lane);
      else
        *d = src[r * (long long)s.L + lane];
    }
  }
}

// Scale rows a tile of `dims` dims uses: dims / bs, or the one row of a
// longer block.
__host__ __device__ __forceinline__ int k4_scale_rows(int dims, int lbs) {
  return (1 << lbs) >= dims ? 1 : dims >> lbs;
}

// Queue tile t (dims t * s.dims ..) of the block's codes (row d at csrc +
// d * L) and their scale rows (row i at ssrc + i * L) into `slot`.
__device__ __forceinline__ void k4_queue_tile(uint8_t* slot, const int8_t* csrc,
                                              const float* ssrc, int lbs, int t,
                                              const K4Shape& s, const K4Block& k,
                                              bool scales16) {
  const int d0 = t * s.dims;
  k4_queue_rows(slot, s.cstr, csrc + (size_t)d0 * s.L, s.dims, s, k, s.codes16);
  k4_queue_rows(slot + s.dims * s.cstr, 4 * s.sstr, ssrc + (size_t)(d0 >> lbs) * s.L,
                k4_scale_rows(s.dims, lbs), s, k, scales16);
}

// Phase 1: scores of the block's lanes. A ring stage holds s.dims dims of
// the K codes [dims][cstr], their scale rows [nsr][sstr] and q's tile
// [dims][rep][G]. Thread (quad lq, dim group dg) takes lanes 4 lq .. 4 lq + 3
// (one 4-byte code load and one 16-byte scale load a dim; where G % 4 == 0
// (Q4) they are heads hh .. hh + 3 of one position, and q comes in one
// 16-byte load a row) and dims dg * dims / dgs .. of every tile, REP rows
// each (0: s.rep at run time). The dim groups are summed in order.
// -> scores [b, nh, S].
template <int REP, bool Q4>
__global__ void __launch_bounds__(kK4Threads)
k4_scores_kernel(const float* __restrict__ q, const int8_t* __restrict__ kc,
                 const float* __restrict__ ks, const int* __restrict__ positions,
                 float* __restrict__ scores, K4Shape s, float sqrt_hd) {
  constexpr int RM = REP ? REP : kRepMax;
  extern __shared__ __align__(16) uint8_t smem_k4[];
  K4Block k;
  if (!k4_block(s, positions, k)) return;
  const int rep = REP ? REP : s.rep, G = s.G, nh = s.nkv * rep;
  const int nsr = k4_scale_rows(s.dims, s.lbs_k), n_tiles = s.hd / s.dims;
  const int8_t* kcb = kc + (size_t)k.b * s.hd * s.L;
  const float* ksb = ks + ((size_t)k.b * s.hd >> s.lbs_k) * s.L;
  const float* qb = q + ((size_t)k.b * nh + (size_t)k.h0 * rep) * s.hd;
  const int qrows = k.gl * rep;

  auto load = [&](int t) {
    uint8_t* slot = smem_k4 + (t % s.stages1) * s.stage1_bytes;
    k4_queue_tile(slot, kcb, ksb, s.lbs_k, t, s, k, s.ks16);
    const int d0 = t * s.dims;
    float* qs = reinterpret_cast<float*>(slot + s.dims * s.cstr + 4 * nsr * s.sstr);
    for (int i = threadIdx.x; i < qrows * s.dims; i += kK4Threads) {
      const int row = i / s.dims, dd = i % s.dims;  // row = hh * rep + r
      cp_async4(qs + (dd * rep + row % rep) * G + row / rep, qb + (size_t)row * s.hd + d0 + dd);
    }
  };
  for (int t = 0; t < s.stages1 - 1; ++t) {
    if (t < n_tiles) load(t);
    cp_async_commit();
  }

  const int nq = (s.P * G + 3) / 4, lq = threadIdx.x % nq, dg = threadIdx.x / nq;
  const int dpg = s.dims / s.dgs, l0 = 4 * lq;
  const bool active = dg < s.dgs && l0 < k.np * G;
  int hq[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) hq[j] = (l0 + j) % G;
  float acc[4][RM];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < RM; ++r) acc[j][r] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait(s.stages1 - 2);  // this thread's copies of tile t have landed
    __syncthreads();               // everyone's have, and everyone is done with t - 1
    if (t + s.stages1 - 1 < n_tiles) load(t + s.stages1 - 1);
    cp_async_commit();
    if (!active) continue;
    const uint8_t* slot = smem_k4 + (t % s.stages1) * s.stage1_bytes;
    const float* ss = reinterpret_cast<const float*>(slot + s.dims * s.cstr);
    const float* qs = ss + nsr * s.sstr;
#pragma unroll 4
    for (int i = 0; i < dpg; ++i) {
      const int dd = dg * dpg + i;
      const uint32_t w =
          *reinterpret_cast<const uint32_t*>(slot + dd * s.cstr + l0) ^ 0x80808080u;
      const float4 sc = *reinterpret_cast<const float4*>(ss + (dd >> s.lbs_k) * s.sstr + l0);
      const float kv[4] = {k4_code(w, 0) * sc.x, k4_code(w, 1) * sc.y, k4_code(w, 2) * sc.z,
                           k4_code(w, 3) * sc.w};
      const float* qd = qs + dd * rep * G;
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        if (!REP && r >= rep) break;
        float qv[4];
        if (Q4) {
          const float4 v = *reinterpret_cast<const float4*>(qd + r * G + hq[0]);
          qv[0] = v.x, qv[1] = v.y, qv[2] = v.z, qv[3] = v.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) qv[j] = qd[r * G + hq[j]];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j][r] = fmaf(qv[j], kv[j], acc[j][r]);
      }
    }
  }
  cp_async_wait(0);
  __syncthreads();
  // the dim groups' sums [dgs][G * rep][pstr], then their sum in group order
  float* red = reinterpret_cast<float*>(smem_k4);
  const int grp_stride = G * rep * s.pstr;
  if (active) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int l = l0 + j;
      if (l >= k.np * G || hq[j] >= k.gl) continue;
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        if (!REP && r >= rep) break;
        red[dg * grp_stride + (hq[j] * rep + r) * s.pstr + l / G] = acc[j][r];
      }
    }
  }
  __syncthreads();
  float* out = scores + ((size_t)k.b * nh + (size_t)k.h0 * rep) * s.S + k.p0;
  for (int i = threadIdx.x; i < qrows * k.np; i += kK4Threads) {
    const int row = i / k.np, pp = i % k.np;
    float a = red[row * s.pstr + pp];
    for (int g = 1; g < s.dgs; ++g) a += red[g * grp_stride + row * s.pstr + pp];
    out[(size_t)row * s.S + pp] = __fdiv_rn(a, sqrt_hd);
  }
}

// Phase 2: per query row (a block a row) the max and the float64
// denominator of exp(score - max) over the filled positions, each thread
// summing its positions in order, then the warps in order; and for prob
// blocks longer than min(P, 32) the max of exp over each block (a warp a
// block). -> stats: max [b, nh], denominator [b, nh], block maxima
// [b, nh, nlb].
__global__ void __launch_bounds__(kK4Threads)
k4_stats_kernel(const float* __restrict__ scores, const int* __restrict__ positions,
                float* __restrict__ stats, K4Shape s, int lpb) {
  constexpr int kWarps = kK4Threads / 32;
  __shared__ float wmax[kWarps];
  __shared__ double wsum[kWarps];
  const int b = blockIdx.y, nh = s.nkv * s.rep;
  const int npos = min(positions[b], s.S - 1) + 1;
  if (npos <= 0) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row = (size_t)b * nh + blockIdx.x;
  const float* sr = scores + row * s.S;
  float m = __int_as_float(0xff800000);  // -inf
#pragma unroll 4
  for (int p = threadIdx.x; p < npos; p += kK4Threads) m = fmaxf(m, sr[p]);
  m = warp_max(m);
  if (lane == 0) wmax[warp] = m;
  __syncthreads();
  m = wmax[0];
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, wmax[w]);
  double sum = 0.0;
#pragma unroll 4
  for (int p = threadIdx.x; p < npos; p += kK4Threads) sum += (double)expf(__fsub_rn(sr[p], m));
  sum = warp_sum(sum);
  if (lane == 0) wsum[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = wsum[0];
    for (int w = 1; w < kWarps; ++w) t += wsum[w];
    stats[row] = m;
    stats[(size_t)s.b * nh + row] = (float)t;
  }
  for (int kb = warp; kb < s.nlb && (kb << lpb) < npos; kb += kWarps) {
    const int end = min((kb + 1) << lpb, npos);
    float e = 0.f;
    for (int p = (kb << lpb) + lane; p < end; p += 32) e = fmaxf(e, expf(__fsub_rn(sr[p], m)));
    e = warp_max(e);
    if (lane == 0) stats[2 * (size_t)s.b * nh + row * s.nlb + kb] = e;
  }
}

// Phase 3: the block's V tiles are queued first; then, from phase 2's
// statistics, the chunk's probabilities, quantized (a block of <=
// min(P, 32) positions by a shuffle of its lanes, a longer one by its max
// of exp over the denominator), into prT [P][rep][G]; then P . deq(V) of
// the chunk a tile: where G % 4 == 0 (Q4), thread (head quad, dim,
// position group) takes heads hh .. hh + 3 (a 4-byte code load, a 16-byte
// scale load and a 16-byte prob load a row and position) and positions
// pg, pg + pgs, ..., the groups summed in order; else a thread an (row,
// dim) output. -> partial [b, nch, hd, nh].
template <int REP, bool Q4>
__global__ void __launch_bounds__(kK4Threads)
k4_pv_kernel(const float* __restrict__ scores, const float* __restrict__ stats,
             const int8_t* __restrict__ vc, const float* __restrict__ vs,
             const int* __restrict__ positions, float* __restrict__ partial, K4Shape s,
             lmq::BfpSpec pq) {
  constexpr int RM = REP ? REP : kRepMax;
  extern __shared__ __align__(16) uint8_t smem_k4[];
  K4Block k;
  if (!k4_block(s, positions, k)) return;
  const int rep = REP ? REP : s.rep, G = s.G, nh = s.nkv * rep;
  const int n_tiles = s.hd / s.dims;
  const int8_t* vcb = vc + (size_t)k.b * s.hd * s.L;
  const float* vsb = vs + ((size_t)k.b * s.hd >> s.lbs_v) * s.L;
  const int qrows = k.gl * rep, maxrows = G * rep;
  // [P][rep][G], after the ring's slots (as many as the tiles, at most stages2)
  float* prT = reinterpret_cast<float*>(smem_k4 + min(s.stages2, n_tiles) * s.stage2_bytes);
  float* mrow = prT + s.P * maxrows;
  float* drow = mrow + maxrows;
  float* red = drow + maxrows;  // [pgs][dims][maxrows]

  auto load = [&](int t) {
    k4_queue_tile(smem_k4 + (t % s.stages2) * s.stage2_bytes, vcb, vsb, s.lbs_v, t, s, k,
                  s.vs16);
  };
  for (int t = 0; t < s.stages2 - 1; ++t) {
    if (t < n_tiles) load(t);
    cp_async_commit();
  }

  const bool shuffle = pq.on && pq.bs <= 32 && pq.bs <= s.P;
  int lpb = 0;
  while ((1 << lpb) < pq.bs) ++lpb;
  const size_t row0 = (size_t)k.b * nh + (size_t)k.h0 * rep;  // the block's first row
  const float* srows = scores + row0 * s.S;
  for (int row = threadIdx.x; row < qrows; row += kK4Threads) {
    mrow[row] = stats[row0 + row];
    drow[row] = stats[(size_t)s.b * nh + row0 + row];
  }
  const float* emax = stats + 2 * (size_t)s.b * nh + row0 * s.nlb;  // [rows][nlb]
  __syncthreads();

  // the chunk's probabilities, element (row, pp) at row * P + pp: a warp
  // holds 32 consecutive ones, so an aligned block of <= min(P, 32) is a run
  // of its lanes
  const int nel = qrows << s.lP, nel32 = (nel + 31) & ~31;
  for (int e = threadIdx.x; e < nel32; e += kK4Threads) {
    const int row = e >> s.lP, pp = e & (s.P - 1);
    float p = 0.f;
    if (e < nel && pp < k.np)
      p = __fdiv_rn(expf(__fsub_rn(srows[(size_t)row * s.S + k.p0 + pp], mrow[row])), drow[row]);
    if (pq.on) {
      float mx = p;
      if (shuffle) {
        for (int o = 1; o < pq.bs; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      } else if (e < nel && pp < k.np) {
        mx = __fdiv_rn(emax[(size_t)row * s.nlb + ((k.p0 + pp) >> lpb)], drow[row]);
      }
      p = lmq::bfp_qdq(p, mx, pq);
    }
    if (e < nel) prT[(pp * rep + row % rep) * G + row / rep] = p;
  }

  const int nitems = (G / 4) * s.dims;  // Q4: (head quad, dim) items
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait(s.stages2 - 2);
    __syncthreads();  // also orders the probabilities, and red's last reads, before this tile
    if (t + s.stages2 - 1 < n_tiles) load(t + s.stages2 - 1);
    cp_async_commit();
    const uint8_t* slot = smem_k4 + (t % s.stages2) * s.stage2_bytes;
    const float* ss = reinterpret_cast<const float*>(slot + s.dims * s.cstr);
    float* pout = partial + (((size_t)k.b * s.nch + k.c) * s.hd + t * s.dims) * nh + k.h0 * rep;
    if (Q4) {
      const int pg = threadIdx.x / min(nitems, kK4Threads);
      for (int it = threadIdx.x % min(nitems, kK4Threads); it < nitems && pg < s.pgs;
           it += kK4Threads) {
        const int dd = it / (G / 4), hh = 4 * (it % (G / 4));
        const uint8_t* crow = slot + dd * s.cstr + hh;
        const float* srow = ss + (dd >> s.lbs_v) * s.sstr + hh;
        float acc[4][RM];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < RM; ++r) acc[j][r] = 0.f;
        for (int pp = pg; pp < k.np; pp += s.pgs) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(crow + pp * G) ^ 0x80808080u;
          const float4 sc = *reinterpret_cast<const float4*>(srow + pp * G);
          const float v[4] = {k4_code(w, 0) * sc.x, k4_code(w, 1) * sc.y, k4_code(w, 2) * sc.z,
                              k4_code(w, 3) * sc.w};
#pragma unroll
          for (int r = 0; r < RM; ++r) {
            if (!REP && r >= rep) break;
            const float4 p4 = *reinterpret_cast<const float4*>(prT + (pp * rep + r) * G + hh);
            acc[0][r] = fmaf(p4.x, v[0], acc[0][r]);
            acc[1][r] = fmaf(p4.y, v[1], acc[1][r]);
            acc[2][r] = fmaf(p4.z, v[2], acc[2][r]);
            acc[3][r] = fmaf(p4.w, v[3], acc[3][r]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < RM; ++r) {
            if (!REP && r >= rep) break;
            red[(pg * s.dims + dd) * maxrows + (hh + j) * rep + r] = acc[j][r];
          }
      }
      __syncthreads();
      for (int o = threadIdx.x; o < qrows * s.dims; o += kK4Threads) {
        const int dd = o / qrows, row = o % qrows;
        float a = red[dd * maxrows + row];
        for (int g = 1; g < s.pgs; ++g) a += red[(g * s.dims + dd) * maxrows + row];
        pout[(size_t)dd * nh + row] = a;
      }
    } else {
      for (int o = threadIdx.x; o < qrows * s.dims; o += kK4Threads) {
        const int dd = o / qrows, row = o % qrows, hh = row / rep, r = row % rep;
        const int8_t* crow = reinterpret_cast<const int8_t*>(slot) + dd * s.cstr + hh;
        const float* srow = ss + (dd >> s.lbs_v) * s.sstr + hh;
        float acc = 0.f;
        for (int pp = 0; pp < k.np; ++pp)
          acc = fmaf(prT[(pp * rep + r) * G + hh], (float)crow[pp * G] * srow[pp * G], acc);
        pout[(size_t)dd * nh + row] = acc;
      }
    }
  }
}

// Phase 4: ctx = the partials of the filled chunks, summed in chunk order.
__global__ void __launch_bounds__(kK4Threads)
k4_sum_kernel(const float* __restrict__ partial, const int* __restrict__ positions,
              float* __restrict__ out, K4Shape s) {
  const int b = blockIdx.y, nh = s.nkv * s.rep;
  const int o = blockIdx.x * kK4Threads + threadIdx.x;  // d * nh + row
  if (o >= s.hd * nh) return;
  const int npos = min(positions[b], s.S - 1) + 1;
  const int live = npos > 0 ? (npos + s.P - 1) >> s.lP : 0;
  const float* src = partial + (size_t)b * s.nch * s.hd * nh + o;
  float acc = 0.f;
  for (int c = 0; c < live; ++c) acc += src[(size_t)c * s.hd * nh];
  out[((size_t)b * nh + o % nh) * s.hd + o / nh] = acc;
}

int ilog2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

cudaError_t allow_dynamic_smem(const void* kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The operands of a K4 call, for its launches.
struct K4Args {
  const float *q, *ks, *vs;
  const int8_t *kc, *vc;
  const int* positions;
  float *scores, *stats, *partial, *out;
  int smem1, smem2;
  float sqrt_hd;
  lmq::BfpSpec pq;
  cudaStream_t stream;
};

template <int REP, bool Q4>
int launch_k4_phases(const K4Shape& s, const K4Args& a) {
  cudaError_t err = allow_dynamic_smem((const void*)k4_scores_kernel<REP, Q4>, a.smem1);
  if (err == cudaSuccess) err = allow_dynamic_smem((const void*)k4_pv_kernel<REP, Q4>, a.smem2);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(s.nch, (s.nkv + s.G - 1) / s.G, s.b);
  k4_scores_kernel<REP, Q4><<<grid, kK4Threads, a.smem1, a.stream>>>(
      a.q, a.kc, a.ks, a.positions, a.scores, s, a.sqrt_hd);
  k4_stats_kernel<<<dim3(s.nkv * s.rep, s.b), kK4Threads, 0, a.stream>>>(
      a.scores, a.positions, a.stats, s, ilog2(a.pq.bs));
  k4_pv_kernel<REP, Q4><<<grid, kK4Threads, a.smem2, a.stream>>>(
      a.scores, a.stats, a.vc, a.vs, a.positions, a.partial, s, a.pq);
  const dim3 grid4((s.hd * s.nkv * s.rep + kK4Threads - 1) / kK4Threads, s.b);
  k4_sum_kernel<<<grid4, kK4Threads, 0, a.stream>>>(a.partial, a.positions, a.out, s);
  return (int)cudaGetLastError();
}

// REP 1, 2, 4 and 8 have instances of their own; 3, 5, 6 and 7 take s.rep
// at run time
template <bool Q4>
int launch_k4_rep(const K4Shape& s, const K4Args& a) {
  switch (s.rep) {
    case 1: return launch_k4_phases<1, Q4>(s, a);
    case 2: return launch_k4_phases<2, Q4>(s, a);
    case 4: return launch_k4_phases<4, Q4>(s, a);
    case 8: return launch_k4_phases<8, Q4>(s, a);
    default: return launch_k4_phases<0, Q4>(s, a);
  }
}

int launch_k4(const void* q, const void* kc, const void* ks, const void* vc, const void* vs,
              const void* positions, void* out, void* ws, int b, int nkv, int rep, int hd,
              int S, int bs_k, int bs_v, int G, int P, float sqrt_hd, lmq::BfpSpec pq,
              cudaStream_t stream) {
  const int lbs_k = ilog2(bs_k), lbs_v = ilog2(bs_v), lP = ilog2(P);
  if (b < 1 || nkv < 1 || S < 1 || rep < 1 || rep > kRepMax || ilog2(hd) < 4 || hd % bs_k ||
      hd % bs_v || lbs_k < 0 || lbs_v < 0 || G < 1 || G > nkv || G * rep > kK4Rows || lP < 0 ||
      P * G > kK4Lanes || (pq.on && ilog2(pq.bs) < 0) || (long long)S * nkv > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  K4Shape s{};
  s.b = b, s.nkv = nkv, s.rep = rep, s.hd = hd, s.S = S, s.L = S * nkv;
  s.G = G, s.P = P, s.lP = lP, s.nch = (S + P - 1) / P;
  s.lbs_k = lbs_k, s.lbs_v = lbs_v;
  s.cstr = (P * G + 15) & ~15;
  s.sstr = (P * G + 3) & ~3;
  s.pstr = P + 1;
  const int rows = G * rep, nq = (P * G + 3) / 4;
  const bool q4 = G % 4 == 0;
  const int lpb = ilog2(pq.bs);
  s.nlb = pq.on && pq.bs > (P < 32 ? P : 32) ? (S + pq.bs - 1) >> lpb : 0;
  // the longest tile (hd up to 128 dims, else 64, 32 or 16; hd a power of
  // two >= 16) with which two ring stages fit in each kernel: fewer tiles,
  // fewer waits; a call allocates the slots of its tiles only
  int smem1 = 0, smem2 = 0;
  for (s.dims = hd < kK4MaxDims ? hd : kK4MaxDims; s.dims >= 16; s.dims /= 2) {
    const int n_tiles = hd / s.dims;
    s.dgs = 1;
    while (2 * s.dgs * nq <= kK4Threads && 2 * s.dgs <= s.dims) s.dgs *= 2;
    s.pgs = 1;
    while (q4 && 2 * s.pgs * (G / 4) * s.dims <= kK4Threads) s.pgs *= 2;
    s.stage1_bytes = s.dims * s.cstr + 4 * k4_scale_rows(s.dims, lbs_k) * s.sstr + 4 * s.dims * rows;
    s.stage2_bytes = s.dims * s.cstr + 4 * k4_scale_rows(s.dims, lbs_v) * s.sstr;
    const int persist2 = 4 * (P * rows + 2 * rows + (q4 ? s.pgs * s.dims * rows : 0));
    const int want = n_tiles < kK4Stages ? (n_tiles > 2 ? n_tiles : 2) : kK4Stages;
    s.stages1 = kSmemMax / s.stage1_bytes < want ? kSmemMax / s.stage1_bytes : want;
    s.stages2 = (kSmemMax - persist2) / s.stage2_bytes < want
                    ? (kSmemMax - persist2) / s.stage2_bytes : want;
    const int red1 = 4 * s.dgs * rows * s.pstr;
    const int slots1 = s.stages1 < n_tiles ? s.stages1 : n_tiles;
    const int slots2 = s.stages2 < n_tiles ? s.stages2 : n_tiles;
    smem1 = slots1 * s.stage1_bytes > red1 ? slots1 * s.stage1_bytes : red1;
    smem2 = slots2 * s.stage2_bytes + persist2;
    if (s.stages1 >= 2 && s.stages2 >= 2 && smem1 <= kSmemMax && smem2 <= kSmemMax) break;
  }
  if (s.dims < 16) return (int)cudaErrorInvalidValue;
  // 16-byte copies where every run starts and ends on 16 bytes
  const auto vec = [&](const void* p, int per) {
    const bool runs = G == nkv ? (P * G) % per == 0 : G % per == 0 && nkv % per == 0;
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.L % per == 0 && runs;
  };
  s.codes16 = vec(kc, 16) && vec(vc, 16);
  s.ks16 = vec(ks, 4);
  s.vs16 = vec(vs, 4);

  // ws: scores [b, nh, S], partials [b, nch, hd, nh], stats (2 + nlb) [b, nh]
  K4Args a{};
  a.q = (const float*)q, a.ks = (const float*)ks, a.vs = (const float*)vs;
  a.kc = (const int8_t*)kc, a.vc = (const int8_t*)vc;
  a.positions = (const int*)positions;
  a.scores = static_cast<float*>(ws);
  a.partial = a.scores + (size_t)b * nkv * rep * S;
  a.stats = a.partial + (size_t)b * s.nch * hd * nkv * rep;
  a.out = (float*)out;
  a.smem1 = smem1, a.smem2 = smem2, a.sqrt_hd = sqrt_hd, a.pq = pq, a.stream = stream;
  return q4 ? launch_k4_rep<true>(s, a) : launch_k4_rep<false>(s, a);
}

}  // namespace

extern "C" {

// K4: pos-major cache, every array [b, rows, S*nkv] with lane = pos*nkv + head;
// ws: float32 scores [b, nh, S] then partials [b, ceil(S / P), hd, nh]; a
// block covers G kv heads and P positions (kernels/attention_decode.py:
// k4_geometry)
int lmq_attn_decode_pos_major(const void* q, const void* kc, const void* ks,
                              const void* vc, const void* vs, const void* positions,
                              void* out, void* ws, int b, int nkv, int rep, int hd, int S,
                              int bs_k, int bs_v, int G, int P, float sqrt_hd, int pq_on,
                              int pq_bs, int pq_width, int pq_emin, int pq_emax,
                              void* stream) {
  return launch_k4(q, kc, ks, vc, vs, positions, out, ws, b, nkv, rep, hd, S, bs_k, bs_v, G, P,
                   sqrt_hd, lmq::BfpSpec{pq_on, pq_bs, pq_width, pq_emin, pq_emax},
                   static_cast<cudaStream_t>(stream));
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
