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
// Both take rep 1..8 query rows a kv head, every head_dim (the wrappers
// bound the operands and the workspace to 32-bit indices) and every K and
// V scale block that divides it: a power of two keeps the tiles, thread groups and shifts it always
// had, another head_dim gets tiles and dim groups that divide it (chosen
// by kernels/attention_decode.py: k4_tiles, k5_tiles, and checked by the
// host code here), and K5's P . V idles the threads past its last whole
// position group. Another block length takes a dim's scale row by a
// counter or a quotient taken once for the dims a thread owns, never by a
// division in an inner loop. A head_dim off 16 bytes stages K5's V codes
// with 4-byte copies; one off 4 bytes stages them a byte at a time into
// rows padded to 4 bytes in shared memory (the cache itself keeps the JAX
// package's layout), whose last, partial group of 4 dims is computed and
// not stored. Past 128 dims, K4 walks a head in ring stages, each stage's
// dims summed into the same scores and written to their own rows of P .
// V's partials; past 1024 dims, K5's P . V walks a chunk once for each
// pass of 1024 dims, each pass's sums in registers; and where two ring
// stages of all of a head's dims do not fit (past 3011 dims at rep 8 and a
// scale a code), K5's scores walk each tile's dims in passes of a divisor
// of hd, q's rows over those dims staged with the K codes.
//
// What bounds them on an H100: the cache bytes (1 byte per code + 4/bs per
// scale, K and V) of the filled positions over the 3.35 TB/s memory rate;
// the work is ~4*hd flops per position and query row (0.4 to 3 flops a
// byte), far under the CUDA cores' rate.
//
// K4. In the pos-major layout the heads of a position are neighbours, so a
// block that owned one (batch element, head) pair read one byte of every
// 32-byte sector and left the rest to the other heads' blocks (the former
// design, which K5 also had until it took K4's phases). K4 instead gives a block all kv heads (G of
// them; G < nkv only past 256 query rows) of a chunk of P positions of one
// batch element (P * G <= 512 lanes; 16 positions at 32 heads): each hd-row
// of its K and V tile is one contiguous run of P * G bytes, and its scale
// rows runs of P * G floats, staged with 16-byte cp.async copies (element
// copies where a run is off 16 bytes), so every sector of the cache is read
// by one block, once. The grid runs over (chunk, head group, batch element)
// (128 blocks at batch 8, 32 heads, S 256), and chunks past positions[b]
// exit at once (read on the device, no host sync). A block queues every
// tile of its K (or V) at once where the ring allows (up to 8 stages), a
// tile being all of hd (up to 128 dims) where two stages fit, else the
// next multiple of 16 that divides hd (64, 32 or 16 for a power of two):
// a block's time went with its number of tiles, not with its bytes
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
// K5. In the head-major layout one (batch element, kv head)'s positions
// are contiguous already: a tile of T positions is hd runs of T code bytes
// and hd / bs runs of T scale floats of K, and one run of T * hd bytes and
// one of T * hd / bs floats of V. The former design gave a block a whole
// (batch element, kv head) pair (256 blocks at batch 8, 32 heads: under 2
// an SM), loaded K and V a byte at a time with 8-16 loads in flight a
// thread, ran the softmax on rep warps and the prob quantizer on one thread
// a block while the other threads waited, and held every score of its rows
// in shared memory (4 * rep * (hd + S + 256) bytes); its P . V alone was
// ~78% of its time (PERF.md). K5 now runs K4's four phases with one head a
// block: a block takes a chunk of P positions of one (batch element, kv
// head) and its rep query rows, walked in tiles of T through a 2-stage
// cp.async ring of 16-byte copies (element copies where a run or a base
// pointer is off 16 bytes), so its shared memory does not grow with S and
// a tile's loads are in flight while the one before it is computed
// (kernels/attention_decode.py: k5_geometry). Every thread works in every
// phase: a thread takes 4 neighbouring positions (scores: one 4-byte code
// load a dim and one q load a row serve the four, the scales multiply the
// sum over a scale block's dims) or 4 neighbouring dims (P . V: one 4-byte
// code load a position, the scale folded into the probability). One C call
// launches:
//   k5_scores_kernel  scores of the chunk into the workspace [b, nh, S]
//                     (K4's layout);
//   k4_stats_kernel   K4's, as it is (it reads only the workspace);
//   k5_pv_kernel      the chunk's probabilities, quantized, and P . deq(V)
//                     into a partial [b, chunk, hd, nh] (K4's layout);
//   k4_sum_kernel     K4's, as it is.

#include <cstdint>
#include <cuda_runtime.h>

#include "bfp_common.cuh"

namespace {

constexpr int kRepMax = 8;
constexpr int kSmemMax = 227 * 1024;

// The scale row of dim d under blocks of bs dims: a shift where bs is a
// power of two (lbs = log2 bs), else a quotient (lbs = -1). For the dims a
// thread owns, once, outside the loops that read the scales.
__host__ __device__ __forceinline__ int block_of(int d, int bs, int lbs) {
  return lbs >= 0 ? d >> lbs : d / bs;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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
  int bs_k, bs_v;          // K and V scale blocks (dims)
  int lbs_k, lbs_v;        // their log2, -1 where not a power of two
  int nsk, nsv;            // K and V scale rows a batch element (hd / bs)
  int cstr, sstr, pstr;    // a stage's code row (bytes) and scale row (floats); a prob row
  int stages1, stage1_bytes, stages2, stage2_bytes;
  int dgs;                 // scores: dim groups of threads
  int pgs;                 // P . V (G % 4 == 0): position groups of threads
  int nlb;                 // prob blocks of > min(P, 32) positions a row (0: none)
  int dims;                // head dims a ring stage: a divisor of hd that fits the blocks
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
__host__ __device__ __forceinline__ int k4_scale_rows(int dims, int bs) {
  return bs >= dims ? 1 : dims / bs;
}

// Queue tile t (dims t * s.dims ..) of the block's codes (row d at csrc +
// d * L) and their scale rows (row i at ssrc + i * L; blocks of bs dims,
// log2 lbs) into `slot`.
__device__ __forceinline__ void k4_queue_tile(uint8_t* slot, const int8_t* csrc,
                                              const float* ssrc, int bs, int lbs, int t,
                                              const K4Shape& s, const K4Block& k,
                                              bool scales16) {
  const int d0 = t * s.dims;
  k4_queue_rows(slot, s.cstr, csrc + (size_t)d0 * s.L, s.dims, s, k, s.codes16);
  k4_queue_rows(slot + s.dims * s.cstr, 4 * s.sstr,
                ssrc + (size_t)block_of(d0, bs, lbs) * s.L, k4_scale_rows(s.dims, bs), s, k,
                scales16);
}

// Phase 1: scores of the block's lanes. A ring stage holds s.dims dims of
// the K codes [dims][cstr], their scale rows [nsr][sstr] and q's tile
// [dims][rep][G]. Thread (quad lq, dim group dg) takes lanes 4 lq .. 4 lq + 3
// (one 4-byte code load and one 16-byte scale load a dim; where G % 4 == 0
// (Q4) they are heads hh .. hh + 3 of one position, and q comes in one
// 16-byte load a row) and dims dg * dims / dgs .. of every tile, REP rows
// each (0: s.rep at run time); a tile's dim dd reads scale row dd / bs_k of
// the stage (a stage starts on a block or inside one), by a shift or, for
// another block length, by a counter. The dim groups are summed in order.
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
  const int nsr = k4_scale_rows(s.dims, s.bs_k), n_tiles = s.hd / s.dims;
  const int8_t* kcb = kc + (size_t)k.b * s.hd * s.L;
  const float* ksb = ks + (size_t)k.b * s.nsk * s.L;
  const float* qb = q + ((size_t)k.b * nh + (size_t)k.h0 * rep) * s.hd;
  const int qrows = k.gl * rep;

  auto load = [&](int t) {
    uint8_t* slot = smem_k4 + (t % s.stages1) * s.stage1_bytes;
    k4_queue_tile(slot, kcb, ksb, s.bs_k, s.lbs_k, t, s, k, s.ks16);
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
  // the scale row of this thread's first dim of a stage, and that dim's
  // place in its block
  const int krow0 = block_of(dg * dpg, s.bs_k, s.lbs_k), kin0 = dg * dpg - krow0 * s.bs_k;
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
    int krow = krow0, kin = kin0;
#pragma unroll 4
    for (int i = 0; i < dpg; ++i) {
      const int dd = dg * dpg + i;
      const uint32_t w =
          *reinterpret_cast<const uint32_t*>(slot + dd * s.cstr + l0) ^ 0x80808080u;
      const int sr = s.lbs_k >= 0 ? dd >> s.lbs_k : krow;
      if (s.lbs_k < 0 && ++kin == s.bs_k) kin = 0, ++krow;
      const float4 sc = *reinterpret_cast<const float4*>(ss + sr * s.sstr + l0);
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
  const float* vsb = vs + (size_t)k.b * s.nsv * s.L;
  const int qrows = k.gl * rep, maxrows = G * rep;
  // [P][rep][G], after the ring's slots (as many as the tiles, at most stages2)
  float* prT = reinterpret_cast<float*>(smem_k4 + min(s.stages2, n_tiles) * s.stage2_bytes);
  float* mrow = prT + s.P * maxrows;
  float* drow = mrow + maxrows;
  float* red = drow + maxrows;  // [pgs][dims][maxrows]

  auto load = [&](int t) {
    k4_queue_tile(smem_k4 + (t % s.stages2) * s.stage2_bytes, vcb, vsb, s.bs_v, s.lbs_v, t, s,
                  k, s.vs16);
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
        const float* srow = ss + block_of(dd, s.bs_v, s.lbs_v) * s.sstr + hh;
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
        const float* srow = ss + block_of(dd, s.bs_v, s.lbs_v) * s.sstr + hh;
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

// a scale block of bs dims that divides the head
bool block_ok(int bs, int hd) { return bs >= 1 && hd % bs == 0; }

// a run of n dims lies inside one scale block of bs dims, or holds whole
// ones
bool fits_blocks(int n, int bs) { return n % bs == 0 || bs % n == 0; }


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
              int S, int bs_k, int bs_v, int G, int P, int dims, int dgs, int pgs,
              float sqrt_hd, lmq::BfpSpec pq, cudaStream_t stream) {
  const int lP = ilog2(P);
  if (b < 1 || nkv < 1 || S < 1 || rep < 1 || rep > kRepMax || hd < 1 ||
      !block_ok(bs_k, hd) || !block_ok(bs_v, hd) || G < 1 || G > nkv || G * rep > kK4Rows ||
      lP < 0 || P * G > kK4Lanes || (pq.on && ilog2(pq.bs) < 0) || (long long)S * nkv > (1LL << 30) ||
      (long long)b * ((S + P - 1) / P) * hd * nkv * rep >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  K4Shape s{};
  s.b = b, s.nkv = nkv, s.rep = rep, s.hd = hd, s.S = S, s.L = S * nkv;
  s.G = G, s.P = P, s.lP = lP, s.nch = (S + P - 1) / P;
  s.bs_k = bs_k, s.bs_v = bs_v, s.lbs_k = ilog2(bs_k), s.lbs_v = ilog2(bs_v);
  s.nsk = hd / bs_k, s.nsv = hd / bs_v;
  s.cstr = (P * G + 15) & ~15;
  s.sstr = (P * G + 3) & ~3;
  s.pstr = P + 1;
  const int rows = G * rep, nq = (P * G + 3) / 4;
  const bool q4 = G % 4 == 0;
  const int lpb = ilog2(pq.bs);
  s.nlb = pq.on && pq.bs > (P < 32 ? P : 32) ? (S + pq.bs - 1) >> lpb : 0;
  // the ring stage's dims, the scores' dim groups and P . V's position
  // groups, chosen by the caller (kernels/attention_decode.py: k4_tiles):
  // checked here against what the kernels take, two ring stages fitting in
  // each kernel's shared memory (a call allocates the slots of its tiles)
  if (dims < 1 || dims > kK4MaxDims || hd % dims || !fits_blocks(dims, bs_k) ||
      !fits_blocks(dims, bs_v) || dgs < 1 || dims % dgs || dgs * nq > kK4Threads || pgs < 1 ||
      (pgs > 1 && !(q4 && pgs * (G / 4) * dims <= kK4Threads)))
    return (int)cudaErrorInvalidValue;
  s.dims = dims, s.dgs = dgs, s.pgs = pgs;
  const int n_tiles = hd / dims;
  // q's tile rounded up to 16 bytes (dims * rows off 4 where dims is), so
  // that every slot starts on 16 bytes
  s.stage1_bytes =
      dims * s.cstr + 4 * k4_scale_rows(dims, bs_k) * s.sstr + ((4 * dims * rows + 15) & ~15);
  s.stage2_bytes = dims * s.cstr + 4 * k4_scale_rows(dims, bs_v) * s.sstr;
  const int persist2 = 4 * (P * rows + 2 * rows + (q4 ? pgs * dims * rows : 0));
  const int want = n_tiles < kK4Stages ? (n_tiles > 2 ? n_tiles : 2) : kK4Stages;
  s.stages1 = kSmemMax / s.stage1_bytes < want ? kSmemMax / s.stage1_bytes : want;
  s.stages2 = (kSmemMax - persist2) / s.stage2_bytes < want
                  ? (kSmemMax - persist2) / s.stage2_bytes : want;
  const int red1 = 4 * dgs * rows * s.pstr;
  const int slots1 = s.stages1 < n_tiles ? s.stages1 : n_tiles;
  const int slots2 = s.stages2 < n_tiles ? s.stages2 : n_tiles;
  const int smem1 = slots1 * s.stage1_bytes > red1 ? slots1 * s.stage1_bytes : red1;
  const int smem2 = slots2 * s.stage2_bytes + persist2;
  if (s.stages1 < 2 || s.stages2 < 2 || smem1 > kSmemMax || smem2 > kSmemMax)
    return (int)cudaErrorInvalidValue;
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

// ---------------------------------------------------------------- K5

constexpr int kK5Threads = 256;

// The shape of a K5 call and its block geometry (set by the host).
struct K5Shape {
  int b, nkv, rep, hd, S;
  int P, nch;              // positions a block (a power of two); chunks of S
  int T, lT;               // positions a ring stage (2^lT): a block's tiles
  int bs_k, bs_v;          // K and V scale blocks (dims)
  int lbs_k, lbs_v;        // their log2, -1 where not a power of two
  int ksr, vsc;            // K scale rows (hd / bs_k); V scales a position (hd / bs_v)
  int cstr, sstr, pstr;    // K tile: a code row (bytes), a scale row (floats); a score row
  int dgs, pgs;            // scores: dim groups; P . V: position groups
  int hdp;                 // hd rounded up to 4: a V code row and a row of P . V's sums
  int kd, np1, ksp;        // scores: head dims a ring stage (a divisor of hd); its passes
                           // (hd / kd); the K scale rows of a stage
  int qfl, qstr;           // q's rows in shared memory: floats kept for the whole call
                           // (rep * hd rounded up to 4; 0 with passes); a row's stride
  int vw, npass;           // P . V: threads of a position group (4 dims each); passes
  int vrow, vss;           // P . V: a stage's V code row (bytes) and scale row (floats)
  int stage1, stage2;      // bytes of a ring stage: K tile, V tile
  int kco, vco, kqo;       // bytes of a K / V stage's codes, rounded up to 16 (scales
                           // follow); a K stage's q rows (with passes), after its scales
  int red1;                // floats of the scores kernel's dim-group sums
  int kc16, ks16, vc16, vs16, q16;  // 16-byte copies (else an element at a time)
  int vc4;                 // V codes by 4-byte copies (where vc16 is off; hd % 4 == 0)
  int vfold;               // bs_v % 4 == 0: a thread's 4 dims share one V scale
  int vs4;                 // bs_v == 1, hd % 4 == 0: a thread's 4 V scales in one load
};

// The block's chunk of (batch element b, kv head h): positions p0 .. p0 +
// np - 1 (np >= 1) of the npos filled ones, in nt tiles of T; bh indexes
// (b, h) in the cache arrays, row0 its first query row of [b * nh]. False
// for a chunk past positions[b].
struct K5Block {
  int b, h, c, p0, np, nt;
  size_t bh, row0;
};

__device__ __forceinline__ bool k5_block(const K5Shape& s, const int* positions, K5Block& k) {
  k.c = blockIdx.x;
  k.h = blockIdx.y;
  k.b = blockIdx.z;
  const int npos = min(positions[k.b], s.S - 1) + 1;
  k.p0 = k.c * s.P;
  if (k.p0 >= npos) return false;
  k.np = min(s.P, npos - k.p0);
  k.nt = (k.np + s.T - 1) >> s.lT;
  k.bh = (size_t)k.b * s.nkv + k.h;
  k.row0 = k.bh * s.rep;
  return true;
}

// Queue `rows` runs of n elements (run r at src + r * S) into dst (run r at
// dst + r * dstr elements): 16-byte copies with `vec` (each run rounded up
// to 16 bytes, which stays inside its row of the cache), else an element
// at a time.
template <typename T>
__device__ __forceinline__ void k5_queue_rows(T* dst, int dstr, const T* src, int rows, int n,
                                              int S, bool vec) {
  constexpr int U = 16 / sizeof(T);
  if (vec) {
    const int per_row = (n + U - 1) / U;
    for (int i = threadIdx.x; i < rows * per_row; i += kK5Threads) {
      const int r = i / per_row, j = (i % per_row) * U;
      cp_async16(dst + r * dstr + j, src + (size_t)r * S + j);
    }
  } else {
    for (int i = threadIdx.x; i < rows * n; i += kK5Threads) {
      const int r = i / n, j = i % n;
      if constexpr (sizeof(T) == 4)
        cp_async4(dst + r * dstr + j, src + (size_t)r * S + j);
      else
        dst[r * dstr + j] = src[(size_t)r * S + j];
    }
  }
}

// Phase 1: scores of the block's rep query rows over its chunk, a tile of
// T positions at a time through a 2-stage cp.async ring: a stage holds kd
// runs of the tile's code bytes ([kd][cstr]) and their scale floats
// ([ksp][sstr]); q's rep rows ([rep][hd]) come first, once. Where kd < hd
// (np1 passes: a head too long for two stages of all its dims) the ring
// walks each tile's dims in passes of kd, each stage also holding q's rows
// over its dims ([rep][qstr]), the sums kept in registers from pass to
// pass. Thread (quad lq, dim group dg) takes positions 4 lq .. 4 lq + 3 of
// the tile and dims dg * kd / dgs .. of a stage, REP rows (0: s.rep at run
// time): one 4-byte code load a dim and one q load a row serve the four
// positions, and q . codes over the dims of one scale row (a run of
// min(kd / dgs, bs_k) dims, the next run the next row) is multiplied by
// that row's four scales (one 16-byte load); the dim groups are summed in
// order. PASSES: an instance of its own for np1 > 1, so that the others
// keep their code. -> scores [b, nh, S].
template <int REP, bool PASSES>
__global__ void __launch_bounds__(kK5Threads)
k5_scores_kernel(const float* __restrict__ q, const int8_t* __restrict__ kc,
                 const float* __restrict__ ks, const int* __restrict__ positions,
                 float* __restrict__ scores, K5Shape s, float sqrt_hd) {
  constexpr int RM = REP ? REP : kRepMax;
  extern __shared__ __align__(16) uint8_t smem_k5[];
  K5Block k;
  if (!k5_block(s, positions, k)) return;
  const int rep = REP ? REP : s.rep;
  float* qs = reinterpret_cast<float*>(smem_k5);  // [rep][hd], without passes
  float* red = qs + s.qfl;                        // [dgs][rep][pstr]
  uint8_t* ring = reinterpret_cast<uint8_t*>(red + s.red1);
  const bool passes = PASSES;
  const int np1 = PASSES ? s.np1 : 1;

  const int8_t* kcb = kc + k.bh * s.hd * s.S + k.p0;
  const float* ksb = ks + k.bh * s.ksr * s.S + k.p0;
  const float* qb = q + k.row0 * s.hd;
  const int nu = k.nt * np1;  // stages: tile u / np1, pass u % np1
  auto load = [&](int u) {
    uint8_t* kt = ring + (u & 1) * s.stage1;
    const int t = PASSES ? u / np1 : u, d0 = (u - t * np1) * s.kd;
    const int t0 = t << s.lT, n = min(s.T, k.np - t0);
    k5_queue_rows(kt, s.cstr, reinterpret_cast<const uint8_t*>(kcb) + (size_t)d0 * s.S + t0,
                  s.kd, n, s.S, s.kc16);
    k5_queue_rows(reinterpret_cast<float*>(kt + s.kco), s.sstr,
                  ksb + (size_t)block_of(d0, s.bs_k, s.lbs_k) * s.S + t0, s.ksp, n, s.S,
                  s.ks16);
    if (passes)
      k5_queue_rows(reinterpret_cast<float*>(kt + s.kqo), s.qstr, qb + d0, rep, s.kd, s.hd,
                    s.q16);
  };
  if (!passes) k5_queue_rows(qs, 0, qb, 1, rep * s.hd, 0, s.q16);
  load(0);
  cp_async_commit();

  const int nq = (s.T + 3) >> 2, lq = threadIdx.x % nq, dg = threadIdx.x / nq;
  const int dpg = s.kd / s.dgs, l0 = 4 * lq;
  const int run = min(dpg, s.bs_k);  // a thread's dims under one scale row
  // the stage's scale row of its first dim (a stage starts on a block or
  // inside one)
  const int kr0 = block_of(dg * dpg, s.bs_k, s.lbs_k);
  float* out = scores + k.row0 * s.S + k.p0;
  float acc[4][RM];
  for (int u = 0; u < nu; ++u) {
    if (u + 1 < nu) load(u + 1);
    cp_async_commit();
    cp_async_wait(1);  // this thread's copies of stage u have landed
    __syncthreads();   // everyone's have
    const uint8_t* kt = ring + (u & 1) * s.stage1;
    const float* kst = reinterpret_cast<const float*>(kt + s.kco);
    const float* qt = passes ? reinterpret_cast<const float*>(kt + s.kqo) : qs;
    const int t = PASSES ? u / np1 : u, pass = u - t * np1;
    const int t0 = t << s.lT, n = min(s.T, k.np - t0);
    const bool active = dg < s.dgs && l0 < n;
    if (pass == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < RM; ++r) acc[j][r] = 0.f;
    }
    if (active) {
      // q . codes over the dims of one scale row, then times the scales
      for (int i0 = 0, kr = kr0; i0 < dpg; i0 += run, ++kr) {
        float part[4][RM];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < RM; ++r) part[j][r] = 0.f;
#pragma unroll 4
        for (int i = i0; i < i0 + run; ++i) {
          const int d = dg * dpg + i;
          const uint32_t w = *reinterpret_cast<const uint32_t*>(kt + d * s.cstr + l0) ^ 0x80808080u;
          const float c[4] = {k4_code(w, 0), k4_code(w, 1), k4_code(w, 2), k4_code(w, 3)};
#pragma unroll
          for (int r = 0; r < RM; ++r) {
            if (!REP && r >= rep) break;
            const float qv = qt[r * s.qstr + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) part[j][r] = fmaf(qv, c[j], part[j][r]);
          }
        }
        const float4 sc4 = *reinterpret_cast<const float4*>(kst + kr * s.sstr + l0);
        const float sc[4] = {sc4.x, sc4.y, sc4.z, sc4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < RM; ++r) {
            if (!REP && r >= rep) break;
            acc[j][r] = fmaf(part[j][r], sc[j], acc[j][r]);
          }
      }
    }
    const bool last = pass == np1 - 1;
    if (active && last) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (l0 + j >= n) break;
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          if (!REP && r >= rep) break;
          red[(dg * rep + r) * s.pstr + l0 + j] = acc[j][r];
        }
      }
    }
    __syncthreads();  // the sums are in; stage u is free for stage u + 2
    if (!last) continue;
    for (int i = threadIdx.x; i < rep * n; i += kK5Threads) {
      const int r = i / n, pp = i % n;
      float a = red[r * s.pstr + pp];
      for (int g = 1; g < s.dgs; ++g) a += red[(g * rep + r) * s.pstr + pp];
      out[(size_t)r * s.S + t0 + pp] = __fdiv_rn(a, sqrt_hd);
    }
  }
}

// Phase 3 (phase 2 is k4_stats_kernel): the block's V tiles, each one run
// of T * hd code bytes and one of T * hd / bs_v scale floats, through a
// 2-stage cp.async ring (a head_dim off 4: the code rows staged a byte at
// a time into rows of hdp bytes), the next tile queued before this one's
// probabilities are built: from phase 2's statistics, quantized (a block
// of <= min(T, 32) positions by a shuffle of its lanes, a longer one by its
// max of exp over the denominator), into prT [T][rep]; then P . deq(V) of
// the tile: thread (dim quad dq, position group pg) takes dims 4 dq .. 4 dq
// + 3 (one 4-byte code load a position; a scale block of a multiple of 4
// dims folds its scale into the probability; the dims past hd of the last
// quad are computed and not stored) and positions pg, pg + pgs, ... of
// every tile, the groups summed in order at the end. Past 1024 dims
// (npass > 1, one position group) the ring walks the chunk once a pass of
// 1024 dims: a stage holds those dims of the tile's code rows ([T][vrow])
// and the scales that cover them ([T][vss]), a thread takes dims 4 dq +
// 1024 i .. of pass i, its sums kept in registers from tile to tile and
// written at the pass's end; the chunk's probabilities are built in the
// first pass and kept for the others ([P][rep]). PASSES: an instance of its own for npass > 1, so that the
// others keep their code.
// -> partial [b, nch, hd, nh].
template <int REP, bool PASSES>
__global__ void __launch_bounds__(kK5Threads)
k5_pv_kernel(const float* __restrict__ scores, const float* __restrict__ stats,
             const int8_t* __restrict__ vc, const float* __restrict__ vs,
             const int* __restrict__ positions, float* __restrict__ partial, K5Shape s,
             lmq::BfpSpec pq, int nlb) {
  constexpr int RM = REP ? REP : kRepMax;
  extern __shared__ __align__(16) uint8_t smem_k5[];
  K5Block k;
  if (!k5_block(s, positions, k)) return;
  const int rep = REP ? REP : s.rep, nh = s.nkv * rep;
  const int npr = PASSES ? s.P : s.T;  // positions whose probabilities are kept
  float* prT = reinterpret_cast<float*>(smem_k5);  // [T][rep], with passes [P][rep]
  float* mrow = prT + npr * rep;
  float* drow = mrow + rep;
  // the ring after them (16-byte aligned); at the end, without passes,
  // the position groups' sums [pgs][rep][hdp] in its place
  uint8_t* ring = smem_k5 + ((4 * (npr * rep + 2 * rep) + 15) & ~15);
  const bool passes = PASSES;
  float* red = reinterpret_cast<float*>(ring);

  const size_t pos0 = k.bh * s.S + k.p0;  // the chunk's first position in the cache
  const int nu = PASSES ? k.nt * s.npass : k.nt;  // stages: pass u / nt, tile u % nt
  auto load = [&](int u) {
    uint8_t* vt = ring + (u & 1) * s.stage2;
    const int i = PASSES ? u / k.nt : 0, t = u - i * k.nt;
    const int t0 = t << s.lT, n = min(s.T, k.np - t0);
    if (passes) {  // pass i's dims of each position: a row of codes, its scales
      const int g0 = 4 * s.vw * i, w = min(4 * s.vw, s.hd - g0);
      const int sb0 = block_of(g0, s.bs_v, s.lbs_v);
      const int ns = block_of(g0 + w - 1, s.bs_v, s.lbs_v) - sb0 + 1;
      const int8_t* src = vc + (pos0 + t0) * s.hd + g0;
      if (s.vc4 && !s.vc16)
        k5_queue_rows(reinterpret_cast<uint32_t*>(vt), s.vrow / 4,
                      reinterpret_cast<const uint32_t*>(src), n, w / 4, s.hd / 4, false);
      else
        k5_queue_rows(reinterpret_cast<int8_t*>(vt), s.vrow, src, n, w, s.hd, s.vc16);
      k5_queue_rows(reinterpret_cast<float*>(vt + s.vco), s.vss,
                    vs + (pos0 + t0) * s.vsc + sb0, n, ns, s.vsc, s.vs16 && sb0 % 4 == 0);
      return;
    }
    if (s.vc16)
      k5_queue_rows(reinterpret_cast<int8_t*>(vt), 0, vc + (pos0 + t0) * s.hd, 1, n * s.hd, 0,
                    true);
    else if (s.vc4)  // hd % 4 == 0: a tile's run of codes is whole 4-byte words
      k5_queue_rows(reinterpret_cast<uint32_t*>(vt), 0,
                    reinterpret_cast<const uint32_t*>(vc + (pos0 + t0) * s.hd), 1,
                    n * s.hd / 4, 0, false);
    else  // a byte at a time, a position's hd codes to a row of hdp bytes
      k5_queue_rows(reinterpret_cast<int8_t*>(vt), s.hdp, vc + (pos0 + t0) * s.hd, n, s.hd,
                    s.hd, false);
    k5_queue_rows(reinterpret_cast<float*>(vt + s.vco), 0, vs + (pos0 + t0) * s.vsc, 1,
                  n * s.vsc, 0, s.vs16);
  };
  load(0);
  cp_async_commit();

  const bool shuffle = pq.on && pq.bs <= 32 && pq.bs <= s.T;
  int lpb = 0;
  while ((1 << lpb) < pq.bs) ++lpb;
  const float* srows = scores + k.row0 * s.S + k.p0;
  for (int r = threadIdx.x; r < rep; r += kK5Threads) {
    mrow[r] = stats[k.row0 + r];
    drow[r] = stats[(size_t)s.b * nh + k.row0 + r];
  }
  const float* emax = stats + 2 * (size_t)s.b * nh + k.row0 * nlb;  // [rep][nlb]
  __syncthreads();

  // pgs whole groups of vw threads; where they do not fill the block, the
  // threads past them idle (pg >= pgs)
  const int dq = threadIdx.x % s.vw, pg = threadIdx.x / s.vw, d0 = 4 * dq;
  const bool pv_on = pg < s.pgs;
  const int nel = rep << s.lT, nel32 = (nel + 31) & ~31;
  float acc[4][RM];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < RM; ++r) acc[j][r] = 0.f;

  // P . deq(V) of the tile's positions pg, pg + pgs, ... < n for the
  // stage's dims dd .. dd + 3 (the head's gd .. gd + 3; the stage's scales
  // start at the head's scale sb0) into a, a loop for each way of taking
  // the scales (a loop that tested the way at each position ran 12% slower
  // at rep 1 on an H100); each dim's scale taken once, clamped to the
  // head's last for the dims past hd, which are not stored
  auto pv = [&](float (&a)[4][RM], int dd, int gd, int sb0, const uint8_t* vt,
                const float* vst, const float* pr, int n) {
    if (s.vfold) {  // one scale for the four dims: folded into the probability
      const int si = block_of(gd, s.bs_v, s.lbs_v) - sb0;
      for (int pp = pg; pp < n; pp += s.pgs) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(vt + pp * s.vrow + dd) ^ 0x80808080u;
        const float c[4] = {k4_code(w, 0), k4_code(w, 1), k4_code(w, 2), k4_code(w, 3)};
        const float sc = vst[pp * s.vss + si];
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          if (!REP && r >= rep) break;
          const float ps = pr[pp * rep + r] * sc;
#pragma unroll
          for (int j = 0; j < 4; ++j) a[j][r] = fmaf(ps, c[j], a[j][r]);
        }
      }
      return;
    }
    int si[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) si[j] = block_of(min(gd + j, s.hd - 1), s.bs_v, s.lbs_v) - sb0;
    for (int pp = pg; pp < n; pp += s.pgs) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(vt + pp * s.vrow + dd) ^ 0x80808080u;
      const float* srow = vst + pp * s.vss;
      const float c[4] = {k4_code(w, 0), k4_code(w, 1), k4_code(w, 2), k4_code(w, 3)};
      float v[4];
      if (s.vs4) {
        const float4 v4 = *reinterpret_cast<const float4*>(srow + (PASSES ? si[0] : dd));
        v[0] = c[0] * v4.x, v[1] = c[1] * v4.y, v[2] = c[2] * v4.z, v[3] = c[3] * v4.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = c[j] * srow[si[j]];
      }
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        if (!REP && r >= rep) break;
        const float p = pr[pp * rep + r];
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j][r] = fmaf(p, v[j], a[j][r]);
      }
    }
  };

  // the block's rows of the partials (taken where they are written, so
  // that no register holds them through the loop)
  auto pout = [&]() {
    return partial + ((size_t)k.b * s.nch + k.c) * s.hd * nh + (size_t)k.h * rep;
  };
  for (int u = 0; u < nu; ++u) {
    if (u + 1 < nu) load(u + 1);
    cp_async_commit();
    const int i = PASSES ? u / k.nt : 0, t = u - i * k.nt;
    const int t0 = t << s.lT, n = min(s.T, k.np - t0);
    float* pr = PASSES ? prT + t0 * rep : prT;  // the tile's probabilities
    // the tile's probabilities (with passes, in the first), element (r, pp)
    // at r * T + pp: a warp holds 32 consecutive ones, so an aligned block
    // of <= min(T, 32) is a run of its lanes
    for (int e = threadIdx.x; e < (i == 0 ? nel32 : 0); e += kK5Threads) {
      const int r = e >> s.lT, pp = e & (s.T - 1);
      const bool live = e < nel && pp < n;
      float p = 0.f;
      if (live)
        p = __fdiv_rn(expf(__fsub_rn(srows[(size_t)r * s.S + t0 + pp], mrow[r])), drow[r]);
      if (pq.on) {
        float mx = p;
        if (shuffle) {
          for (int o = 1; o < pq.bs; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        } else if (live) {
          mx = __fdiv_rn(emax[(size_t)r * nlb + ((k.p0 + t0 + pp) >> lpb)], drow[r]);
        }
        p = lmq::bfp_qdq(p, mx, pq);
      }
      if (e < nel) pr[pp * rep + r] = p;
    }
    cp_async_wait(1);  // this thread's copies of stage u have landed
    __syncthreads();   // everyone's have, and the probabilities are in
    const uint8_t* vt = ring + (u & 1) * s.stage2;
    const float* vst = reinterpret_cast<const float*>(vt + s.vco);
    const int gd = 4 * s.vw * i + d0;  // the head's dims of this thread's quad
    if (!passes) {
      if (pv_on) pv(acc, d0, d0, 0, vt, vst, pr, n);
    } else if (gd < s.hd) {  // pass i's sums in acc from tile to tile
      if (t == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < RM; ++r) acc[j][r] = 0.f;
      }
      pv(acc, d0, gd, block_of(4 * s.vw * i, s.bs_v, s.lbs_v), vt, vst, pr, n);
      if (t == k.nt - 1) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (gd + j >= s.hd) break;
#pragma unroll
          for (int r = 0; r < RM; ++r) {
            if (!REP && r >= rep) break;
            pout()[(size_t)(gd + j) * nh + r] = acc[j][r];
          }
        }
      }
    }
    __syncthreads();  // stage u and the probabilities are free
  }
  if constexpr (PASSES) return;
  // the position groups' sums [pgs][rep][hdp], in the ring's place
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    if ((!REP && r >= rep) || !pv_on) break;
    *reinterpret_cast<float4*>(red + (pg * rep + r) * s.hdp + d0) =
        make_float4(acc[0][r], acc[1][r], acc[2][r], acc[3][r]);
  }
  __syncthreads();
  float* po = pout();
  for (int o = threadIdx.x; o < rep * s.hd; o += kK5Threads) {
    const int d = o / rep, r = o % rep;
    float a = red[r * s.hdp + d];
    for (int g = 1; g < s.pgs; ++g) a += red[(g * rep + r) * s.hdp + d];
    po[(size_t)d * nh + r] = a;
  }
}

// The operands of a K5 call, for its launches.
struct K5Args {
  const float *q, *ks, *vs;
  const int8_t *kc, *vc;
  const int* positions;
  float *scores, *stats, *partial, *out;
  int smem1, smem2, lpb;
  float sqrt_hd;
  lmq::BfpSpec pq;
  cudaStream_t stream;
};

// P1: the scores' passes (np1 > 1: one instance, REP 0, beside P . V's
// passes, which also serve a head of one pass); P2: P . V's (npass > 1)
template <int REP, bool P1, bool P2>
int launch_k5_phases(const K5Shape& s, const K4Shape& s4, const K5Args& a) {
  cudaError_t err = allow_dynamic_smem((const void*)k5_scores_kernel<REP, P1>, a.smem1);
  if (err == cudaSuccess) err = allow_dynamic_smem((const void*)k5_pv_kernel<REP, P2>, a.smem2);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(s.nch, s.nkv, s.b);
  k5_scores_kernel<REP, P1><<<grid, kK5Threads, a.smem1, a.stream>>>(
      a.q, a.kc, a.ks, a.positions, a.scores, s, a.sqrt_hd);
  k4_stats_kernel<<<dim3(s.nkv * s.rep, s.b), kK4Threads, 0, a.stream>>>(
      a.scores, a.positions, a.stats, s4, a.lpb);
  k5_pv_kernel<REP, P2><<<grid, kK5Threads, a.smem2, a.stream>>>(
      a.scores, a.stats, a.vc, a.vs, a.positions, a.partial, s, a.pq, s4.nlb);
  const dim3 grid4((s.hd * s.nkv * s.rep + kK4Threads - 1) / kK4Threads, s.b);
  k4_sum_kernel<<<grid4, kK4Threads, 0, a.stream>>>(a.partial, a.positions, a.out, s4);
  return (int)cudaGetLastError();
}

// REP 1, 2, 4 and 8 have instances of their own; 3, 5, 6 and 7 take s.rep
// at run time
template <bool P2>
int launch_k5_rep(const K5Shape& s, const K4Shape& s4, const K5Args& a) {
  switch (s.rep) {
    case 1: return launch_k5_phases<1, false, P2>(s, s4, a);
    case 2: return launch_k5_phases<2, false, P2>(s, s4, a);
    case 4: return launch_k5_phases<4, false, P2>(s, s4, a);
    case 8: return launch_k5_phases<8, false, P2>(s, s4, a);
    default: return launch_k5_phases<0, false, P2>(s, s4, a);
  }
}

int launch_k5(const void* q, const void* kc, const void* ks, const void* vc, const void* vs,
              const void* positions, void* out, void* ws, int b, int nkv, int rep, int hd,
              int S, int bs_k, int bs_v, int P, int T, int dims, int dgs, int pgs,
              float sqrt_hd, lmq::BfpSpec pq, cudaStream_t stream) {
  const int lP = ilog2(P);
  if (b < 1 || nkv < 1 || S < 1 || rep < 1 || rep > kRepMax || hd < 1 || !block_ok(bs_k, hd) ||
      !block_ok(bs_v, hd) || lP < 0 || ilog2(T) < 0 || T > P || (pq.on && ilog2(pq.bs) < 0))
    return (int)cudaErrorInvalidValue;
  K5Shape s{};
  s.b = b, s.nkv = nkv, s.rep = rep, s.hd = hd, s.S = S;
  s.P = P, s.nch = (S + P - 1) / P;
  s.bs_k = bs_k, s.bs_v = bs_v, s.lbs_k = ilog2(bs_k), s.lbs_v = ilog2(bs_v);
  s.ksr = hd / bs_k, s.vsc = hd / bs_v;
  s.hdp = (hd + 3) & ~3;
  // P . V: a thread 4 dims of a pass, up to 1024 dims a pass
  const int nd4 = s.hdp / 4;
  s.vw = nd4 < kK5Threads ? nd4 : kK5Threads;
  s.npass = (nd4 + s.vw - 1) / s.vw;
  // the ring stage's positions and head dims of the scores (all of hd, or
  // passes of a divisor that fits the K blocks), the scores' dim groups
  // (each group's runs under one K scale) and P . V's position groups (the
  // threads past pgs whole groups of vw idle; one group where a head takes
  // passes), chosen by the caller (kernels/attention_decode.py: k5_tiles):
  // checked here, two ring stages fitting in each kernel's shared memory
  const int nq = (T + 3) / 4;
  const bool p2 = s.npass > 1 || (dims >= 1 && dims < hd);  // P . V's instance with passes
  if (dims < 1 || hd % dims || !fits_blocks(dims, bs_k) || dgs < 1 || dims % dgs ||
      !fits_blocks(dims / dgs, bs_k) || dgs * nq > kK5Threads || pgs < 1 ||
      pgs * s.vw > kK5Threads || (p2 && pgs != 1))
    return (int)cudaErrorInvalidValue;
  s.T = T, s.lT = ilog2(T), s.dgs = dgs, s.pgs = pgs;
  s.kd = dims, s.np1 = hd / dims, s.ksp = k4_scale_rows(dims, bs_k);
  s.qfl = s.np1 > 1 ? 0 : (rep * hd + 3) & ~3;
  s.qstr = s.np1 > 1 ? (dims + 3) & ~3 : hd;
  // a K code row: 16-byte copies of T >= 16 positions, else element
  // copies into rows of 4-byte words
  s.cstr = T >= 16 ? (T + 15) & ~15 : (T + 3) & ~3;
  s.sstr = (T + 3) & ~3;
  s.pstr = T + 1;
  s.red1 = (dgs * rep * s.pstr + 3) & ~3;
  s.kco = (dims * s.cstr + 15) & ~15;
  s.kqo = s.kco + 4 * s.ksp * s.sstr;
  s.stage1 = s.kqo + (s.np1 > 1 ? 4 * rep * s.qstr : 0);
  // P . V's stage: rows of all hd, or with passes of a pass's 1024 dims
  // and the most scales a pass's dims take
  s.vrow = p2 ? 4 * s.vw : s.hdp;
  s.vss = s.vsc;
  if (p2) {
    int most = 0;
    for (int g0 = 0; g0 < hd; g0 += s.vrow) {
      const int g1 = (g0 + s.vrow < hd ? g0 + s.vrow : hd) - 1;
      const int ns = block_of(g1, bs_v, s.lbs_v) -
                     block_of(g0, bs_v, s.lbs_v) + 1;
      most = ns > most ? ns : most;
    }
    s.vss = (most + 3) & ~3;
  }
  s.vco = (T * s.vrow + 15) & ~15;
  s.stage2 = s.vco + 4 * ((T * s.vss + 3) & ~3);
  const int smem1 = 4 * (s.qfl + s.red1) + 2 * s.stage1;
  const int ring2 = 2 * s.stage2, red2 = 4 * pgs * rep * s.hdp;
  // with passes the chunk's probabilities, else the tile's
  const int smem2 = ((4 * ((p2 ? P : T) * rep + 2 * rep) + 15) & ~15) +
                    (p2 ? ring2 : (ring2 > red2 ? ring2 : red2));
  if (smem1 > kSmemMax || smem2 > kSmemMax) return (int)cudaErrorInvalidValue;
  // 16-byte copies where every run starts on 16 bytes and ends inside its
  // row when rounded up to 16 bytes: codes by the position (K) or by hd % 16
  // == 0 (V, else 4-byte copies where hd % 4 == 0, else bytes); scales by
  // 4 floats; q by hd % 4 == 0
  const auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  s.kc16 = al(kc) && S % 16 == 0 && s.T % 16 == 0;
  s.ks16 = al(ks) && S % 4 == 0 && s.T % 4 == 0;
  s.vc16 = al(vc) && hd % 16 == 0;
  s.vc4 = !s.vc16 && hd % 4 == 0 && reinterpret_cast<uintptr_t>(vc) % 4 == 0;
  s.vs16 = al(vs) && s.vsc % 4 == 0;
  s.q16 = al(q) && hd % 4 == 0 && dims % 4 == 0;
  s.vfold = bs_v % 4 == 0;
  s.vs4 = bs_v == 1 && hd % 4 == 0;

  // K4's stats and sum kernels read only the workspace: K4's shape with
  // one head a block, chunks of P, and a max of exp for each prob block
  // longer than min(T, 32) (the workspace holds them: k4_workspace_floats
  // with K5's T)
  K4Shape s4{};
  s4.b = b, s4.nkv = nkv, s4.rep = rep, s4.hd = hd, s4.S = S, s4.L = S * nkv;
  s4.G = 1, s4.P = P, s4.lP = lP, s4.nch = s.nch;
  const int lpb = ilog2(pq.bs);
  const int shuffle_max = s.T < 32 ? s.T : 32;
  s4.nlb = pq.on && pq.bs > shuffle_max ? (S + pq.bs - 1) >> lpb : 0;

  // ws: scores [b, nh, S], partials [b, nch, hd, nh], stats (2 + nlb) [b, nh]
  K5Args a{};
  a.q = (const float*)q, a.ks = (const float*)ks, a.vs = (const float*)vs;
  a.kc = (const int8_t*)kc, a.vc = (const int8_t*)vc;
  a.positions = (const int*)positions;
  a.scores = static_cast<float*>(ws);
  a.partial = a.scores + (size_t)b * nkv * rep * S;
  a.stats = a.partial + (size_t)b * s.nch * hd * nkv * rep;
  a.out = (float*)out;
  a.smem1 = smem1, a.smem2 = smem2, a.lpb = lpb, a.sqrt_hd = sqrt_hd, a.pq = pq;
  a.stream = stream;
  if (s.np1 > 1) return launch_k5_phases<0, true, true>(s, s4, a);
  return p2 ? launch_k5_rep<true>(s, s4, a) : launch_k5_rep<false>(s, s4, a);
}

}  // namespace

extern "C" {

// K4: pos-major cache, every array [b, rows, S*nkv] with lane = pos*nkv + head;
// ws: float32 scores [b, nh, S] then partials [b, ceil(S / P), hd, nh]; a
// block covers G kv heads and P positions (kernels/attention_decode.py:
// k4_geometry), in ring stages of dims head dims, dgs dim groups and pgs
// position groups (k4_tiles)
int lmq_attn_decode_pos_major(const void* q, const void* kc, const void* ks,
                              const void* vc, const void* vs, const void* positions,
                              void* out, void* ws, int b, int nkv, int rep, int hd, int S,
                              int bs_k, int bs_v, int G, int P, int dims, int dgs, int pgs,
                              float sqrt_hd, int pq_on, int pq_bs, int pq_width, int pq_emin,
                              int pq_emax, void* stream) {
  return launch_k4(q, kc, ks, vc, vs, positions, out, ws, b, nkv, rep, hd, S, bs_k, bs_v, G, P,
                   dims, dgs, pgs, sqrt_hd,
                   lmq::BfpSpec{pq_on, pq_bs, pq_width, pq_emin, pq_emax},
                   static_cast<cudaStream_t>(stream));
}

// K5: head-major cache, K [b, nkv, hd, S] / [b, nkv, hd/bs, S],
// V [b, nkv, S, hd] / [b, nkv, S, hd/bs]; ws: float32 scores [b, nh, S],
// partials [b, ceil(S / P), hd, nh] and stats; a block covers P positions
// of one kv head (kernels/attention_decode.py: k5_geometry), in ring stages
// of T positions and dims head dims, dgs dim groups and pgs position
// groups (k5_tiles)
int lmq_attn_decode_head_major(const void* q, const void* kc, const void* ks,
                               const void* vc, const void* vs, const void* positions,
                               void* out, void* ws, int b, int nkv, int rep, int hd, int S,
                               int bs_k, int bs_v, int P, int T, int dims, int dgs,
                               int pgs, float sqrt_hd, int pq_on, int pq_bs, int pq_width,
                               int pq_emin, int pq_emax, void* stream) {
  return launch_k5(q, kc, ks, vc, vs, positions, out, ws, b, nkv, rep, hd, S, bs_k, bs_v, P, T,
                   dims, dgs, pgs, sqrt_hd, lmq::BfpSpec{pq_on, pq_bs, pq_width, pq_emin, pq_emax},
                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"
