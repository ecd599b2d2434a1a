// Fused dequant-matmul kernels K1, K2 and K3: y[M, N] = actq(x)[M, K] . deq(W)^T.
//
// K1 replaces llm_mixed_q_tpu/kernels/dequant_matmul.py
//    bfp_matmul_subbyte_t_pallas / _subbyte_t_kernel (PackedBFPSubT:
//    uint32 words [K_pad / per_word, N], uint8 scale exponents [K_pad / bs, N]).
// K2 replaces llm_mixed_q_tpu/kernels/dequant_matmul.py
//    bfp_matmul_pallas / _dequant_matmul_kernel (PackedBFP: int8 codes
//    [N, K_pad], float32 scales [N, K_pad / bs]).
// K3 replaces llm_mixed_q_tpu/kernels/dequant_matmul.py
//    bfp_matmul_subbyte_pallas / _subbyte_kernel (PackedBFPSub, lane-major:
//    uint32 words [N, K_pad / per_word], where bits width*j of word t*128 + r
//    hold K row t*tile + j*128 + r; uint8 scale exponents
//    [n_tiles, N, tile / bs]). The TPU kernel's `tps` (packing tiles a grid
//    step) is a TPU tiling knob with no counterpart here, so its silent
//    reset to 1 does not carry over.
// K1 folds the block_fp activation quantizer (_qdq_lanes_signed on the
// TPU) into its prologue: each block quantizes its K-step of x on the way
// into shared memory, a quantizer block being a run of 1..32 lanes of a
// warp. K2 and K3 run it once a call, in a kernel of its own (actq_split),
// that writes x as two bf16 terms into a workspace; the same C call then
// launches the matmul on that workspace with programmatic dependent launch
// (PDL): the matmul's blocks start while actq_split runs, queue the first
// ring stages of their weights (which do not depend on x), and wait for
// actq_split (griddepcontrol.wait) before their first read of the
// workspace.
//
// What bounds them on an H100: at decode M (<= 16 rows) the product does
// 2*M flops per weight element and reads the packed weight once, so its
// bytes (the packed weight, plus 4*M*(K+N) for x and y) over the 3.35 TB/s
// memory rate bound it (Llama-2-7B: ~6.9 bits per element sub-byte, 10 bits
// int8; K1 and K3 read the same bytes, in two layouts, bound 0.0571 ms a
// layer at M = 8; K2's bound is 0.0765 ms; the operations at the bf16
// tensor-core peak pass the bytes only near M = 256). All three multiply on
// the tensor cores (mma.sync m16n8k16, bf16 operands, float32
// accumulators), with A and B swapped so that N fills the mma's 16-row side
// and the batch its 8-column side: at M = 8 no tensor-core work goes to
// padding rows. Their operands are exact in bf16: a code (minus cmax for
// the sub-byte ones) has at most 8 significant bits and its scale is a
// power of two; x is carried as hi = bf16(x) plus lo = bf16(x - hi), and
// the lo products run only where some row has a nonzero lo (block_fp
// activations of width <= 9 have none; raw float32 x does), leaving about
// 2^-17 of |x| (absolute 2^-134 below 2^-117, where bf16 is subnormal). So
// each differs from the plain version only in the order of its float32
// sums. Each row is summed in a fixed order (per warp, then the warps
// combined in a fixed order): a row's result does not depend on M or on the
// other rows (no split across blocks, no atomics).
// - K1: the words and scale bytes of a packing tile go to a 3-tile ring in
//   shared memory by cp.async (16 bytes a thread, coalesced along N); the
//   next tile's x is loaded into registers (a float4 a lane) while the
//   block computes this one, then quantized (a quantizer block is 1..8
//   lanes of 4 values) and stored as B fragments in one of two buffers, so
//   one barrier a tile suffices. 16 word rows at one shift are one k16
//   step: a warp's 8 words of a 16 x 16 block feed per_word steps. Warp w
//   takes the 16 columns (w % 2) and word-row groups w / 2 and w / 2 + 4 of
//   every tile; the 4 warps of a column tile are summed in a fixed order at
//   the end. At M = 8 it is not bound by the weight bytes (~9x its byte
//   bound on an H100, see PERF.md): each 32-column block still stages and
//   quantizes all of x, and 2 blocks of 128 registers a thread leave 4
//   warps a scheduler to hide the latency of a tile's barrier and dependent
//   mma chain.
// - K2: actq_split quantizes x once a call (a block a row and 512 K) and
//   writes hi = bf16(q) and lo = bf16(q - hi) [M][kw] and a flag a row and
//   512 K where lo is nonzero; with no quantizer it only splits, so raw float32 x keeps
//   float32 semantics as in K1. int8_kernel then streams codes [N, K_pad]
//   (A's natural row-major layout), float32 scales and x hi through a
//   4-stage cp.async ring (16 bytes a thread, coalesced along K); lo comes
//   straight from the workspace, in L2, and its products run only when some
//   row of the block has a lo. A code times its power-of-two scale is exact
//   in bf16 down to scales of 2^-133; below that (no packer pairs such a
//   scale with a nonzero code) the scale goes into the mma as s * 2^64 and
//   2^-64 is applied in float32. Weight blocks of 1 and 2 (one scale a code
//   or a pair) take a path of their own (a template parameter, so the bs >=
//   4 instructions are those of the shipped path): no scales in the ring,
//   each lane reads its codes' scales from L2 (__ldg) and applies them, and
//   the lift, a code at a time. A block owns 32 columns where that leaves
//   every SM 2 blocks, else 16 (N = 4096: 256 blocks), and 8 or 16 rows (3
//   blocks an SM at 32 columns and 8 rows, else 2: the ring's bytes in
//   flight, not the arithmetic, bound it, see PERF.md); its 8 warps split
//   the columns into 16-row tiles and K into 64-wide groups of every stage,
//   summed in a fixed order at the end. Row blocks run next to each other,
//   so at prefill M they share a column block's weights through L2.
// - K3: the same C call runs actq_split, then subbyte_kernel on K2's design:
//   a cp.async ring of up to 4 stages (as many as leave every SM 2 blocks;
//   wide tiles of width 2 or 3 take fewer), a stage being one packing tile
//   of the block's columns: its 128 word rows (a column's words contiguous,
//   16 bytes a thread, coalesced along K), the column's scale bytes of the
//   tile (one contiguous run of the block's columns) and x hi at the tile's
//   K. Columns and rows a block as K2 (32 or 16 by N alone; 8 or 16). The K
//   permutation: a lane (g, tig) loads 4 consecutive words of a column, word
//   rows r0 + 4 tig .. + 3 of a 16-row group r0; slice j of them holds K
//   rows j*128 + r0 + 4 tig .. + 3 of the tile, which go to the mma's k
//   2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9. So a quad covers 16 consecutive
//   K of slice j: a 16-row group gives per_word k16 steps from one 16-byte
//   load a column, and B takes x hi (and lo) at the same 4 consecutive K of
//   its row (8 bytes a lane, in K's own order). A code minus cmax times
//   2^(byte - 128) is exact in bf16 for every byte (bf16 subnormals are
//   multiples of 2^-133; a product of 2^128 or more, from bytes 254 and 255,
//   is inf in both versions), so no scale needs K2's lift. bs >= 4 gives a lane's 4 K one
//   scale a column; bs 1 and 2 take one a code. Warp w takes the column tile
//   w % (COLS / 16) and word-row groups of every tile (2 at 32 columns, 1 at
//   16), summed in a fixed order at the end; lo comes from the workspace, as
//   in K2. On an H100 this is 3.3x faster than the former CUDA-core design
//   at M = 8 and 8x at M = 256, ~4x its byte bound at M = 8; half-tile
//   stages at 3 blocks an SM, and per_word as a template parameter (its
//   loop unrolled, 128 registers with spills), were slower at M = 8
//   (PERF.md).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bfp_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 32;                      // output columns per block
constexpr int kSlice = 128;                    // K1, K3: word rows of a packing tile
constexpr int kSmemMax = 227 * 1024;

__device__ __forceinline__ float scale_from_e8(uint8_t e8) {
  return lmq::exact_exp2i((int)e8 - 128);
}

// ---------------------------------------------------------------- K1

constexpr int kK1Stages = 3;                  // packing tiles of words in flight
constexpr int kK1TileWords = kSlice * kCols;  // words of one tile of a block's columns

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 (or 4) bytes global -> shared, asynchronously; bytes past `valid`
// are zero-filled (valid = 0 reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Programmatic dependent launch (Hopper): a kernel launched after another
// with cudaLaunchAttributeProgrammaticStreamSerialization may start once
// every block of the one before it has run launch_dependents (or exited);
// its wait returns when that grid has finished and its writes are visible
// (at once for a kernel launched without the attribute).
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// d += a . b on the tensor cores: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col),
// d 16 x 8 float32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// two floats -> bf16x2 (the first in the low half), round to nearest even
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Word (row, col) of a tile's [kSlice][kCols] words in shared memory. The
// XOR spreads the 4 word rows an A fragment load touches over all banks.
__device__ __forceinline__ int k1_word_slot(int row, int col) {
  return row * kCols + (col ^ (((row >> 1) & 3) << 3));
}

// Bytes of a ring slot: the tile's words, then its nsb scale rows of kCols
// bytes, rounded up to 16.
__host__ __device__ __forceinline__ int k1_slot_bytes(int nsb) {
  return 4 * kK1TileWords + (nsb * kCols + 15) / 16 * 16;
}

// Queue tile t's words and scale bytes of columns col0 .. col0 + kCols - 1
// into ring slot `dst` (zero past N): 16-byte copies where the rows allow
// them (N % 4 == 0 for words, N % 16 == 0 for scales: a run of columns is
// then all in or all out), else 4-byte ones, else (scales with N % 4 != 0)
// plain loads.
__device__ __forceinline__ void k1_load_tile(uint8_t* dst, const uint32_t* __restrict__ words,
                                             const uint8_t* __restrict__ scales, int t,
                                             int nsb, int col0, int N) {
  uint32_t* dw = reinterpret_cast<uint32_t*>(dst);
  const uint32_t* src = words + (size_t)t * kSlice * N;
  if (N % 4 == 0) {
    for (int i = threadIdx.x; i < kK1TileWords / 4; i += kThreads) {
      const int row = i / (kCols / 4), col = 4 * (i % (kCols / 4));
      const bool in = col0 + col < N;
      cp_async16(dw + k1_word_slot(row, col), in ? src + (size_t)row * N + col0 + col : words,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kK1TileWords; i += kThreads) {
      const int row = i / kCols, col = i % kCols;
      const bool in = col0 + col < N;
      cp_async4(dw + k1_word_slot(row, col), in ? src + (size_t)row * N + col0 + col : words,
                in ? 4 : 0);
    }
  }
  uint8_t* ds = dst + 4 * kK1TileWords;  // [nsb][kCols]
  const uint8_t* ssrc = scales + (size_t)t * nsb * N + col0;
  if (N % 16 == 0) {
    for (int i = threadIdx.x; i < nsb * (kCols / 16); i += kThreads) {
      const int row = i / (kCols / 16), col = 16 * (i % (kCols / 16));
      const bool in = col0 + col < N;
      cp_async16(ds + row * kCols + col, in ? ssrc + (size_t)row * N + col : scales, in ? 16 : 0);
    }
  } else if (N % 4 == 0) {
    for (int i = threadIdx.x; i < nsb * (kCols / 4); i += kThreads) {
      const int row = i / (kCols / 4), col = 4 * (i % (kCols / 4));
      const bool in = col0 + col < N;
      cp_async4(ds + row * kCols + col, in ? ssrc + (size_t)row * N + col : scales, in ? 4 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < nsb * kCols; i += kThreads) {
      const int row = i / kCols, col = i % kCols;
      ds[i] = col0 + col < N ? __ldg(ssrc + (size_t)row * N + col) : 0;
    }
  }
}

// Block_fp fake-quantization of x given its block's abs max, equal to
// lmq::bfp_qdq: ceil(log2) from the exponent bits (block_max > 1e-8 is a
// normal float) and one multiplication by 2^(mbits - e) in place of the
// two by 2^-e and 2^mbits (they differ only where the mantissa rounds to 0
// either way); exponents near the ends of the range take lmq::bfp_qdq_exp.
__device__ __forceinline__ float k1_qdq(float x, float block_max, const lmq::BfpSpec& aq) {
  if (fabsf(x) <= 1e-8f) return x;
  const uint32_t bits = __float_as_uint(block_max);
  int e = (int)(bits >> 23) - 127 + ((bits & 0x7fffffu) != 0u);
  e = max(aq.emin, min(aq.emax, e));
  if (e > 120 || e < -100) return lmq::bfp_qdq_exp(x, e, aq);
  const int mbits = aq.width - 1;
  const float scaled = __fmul_rn(__fadd_rn(fabsf(x), 1e-9f), lmq::exact_exp2i(mbits - e));
  const float mant = fminf(rintf(scaled), (float)((1 << mbits) - 1));
  const float r = __fmul_rn(mant, lmq::exact_exp2i(e - mbits));
  return x > 0.f ? r : -r;
}

// Load this thread's x of tile k0 .. k0 + tile - 1 into registers: unit i
// is warp unit wu = warp + kWarps i, row wu % R and K positions
// 128 (wu / R) + 4 lane .. + 3 of the tile; 0 past K and past the live
// rows. The next tile's x is in flight while the block computes this one.
template <int R, int P>
__device__ __forceinline__ void k1_load_x(float (&v)[P][4], const float* __restrict__ x,
                                          int k0, int m0, int rows, int K, bool vec) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int wu = warp + kWarps * i, m = wu % R;
    const int k = k0 + kSlice * (wu / R) + 4 * lane;
    const float* src = x + (size_t)(m0 + m) * K + k;
    if (m >= rows || k >= K) {
      v[i][0] = v[i][1] = v[i][2] = v[i][3] = 0.f;
    } else if (vec && k + 3 < K) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(src));
      v[i][0] = f.x, v[i][1] = f.y, v[i][2] = f.z, v[i][3] = f.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) v[i][u] = k + u < K ? __ldg(src + u) : 0.f;
    }
  }
}

// Quantize the loaded x and store it as the B fragments of the mma: bf16
// hi = bf16(v) and lo = bf16(v - hi), each [tile / 16 k-steps][R / 8 row
// tiles][32 lanes][4 bf16], the lanes of k-step s XOR-permuted by
// 4 (s % 8) so that a warp's stores spread over the banks. Returns whether
// this thread stored a nonzero lo. A quantizer block (aq.bs | 32) is held
// by one thread (bs <= 4) or by a run of bs / 4 lanes.
template <int R, int P>
__device__ __forceinline__ bool k1_store_x(uint32_t* xhi, uint32_t* xlo, float (&v)[P][4],
                                           const lmq::BfpSpec& aq) {
  constexpr int NT = R / 8;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  uint32_t lo_bits = 0;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int wu = warp + kWarps * i, m = wu % R;
    float q[4] = {v[i][0], v[i][1], v[i][2], v[i][3]};
    if (aq.on) {
      float a[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = fabsf(q[u]);
      if (aq.bs >= 2) {
        a[0] = a[1] = fmaxf(a[0], a[1]);
        a[2] = a[3] = fmaxf(a[2], a[3]);
      }
      if (aq.bs >= 4) a[0] = a[1] = a[2] = a[3] = fmaxf(a[0], a[2]);
      for (int o = 1; o < aq.bs / 4; o <<= 1)
        a[0] = a[1] = a[2] = a[3] = fmaxf(a[0], __shfl_xor_sync(0xffffffffu, a[0], o));
#pragma unroll
      for (int u = 0; u < 4; ++u) q[u] = k1_qdq(q[u], a[u], aq);
    }
    // K position kk = 128 (wu / R) + 4 lane + u of the tile: k-step kk / 16,
    // k16 = 4 (lane % 4) + u, i.e. register k16 / 8 of lane
    // (m % 8) * 4 + (k16 % 8) / 2; the pair u = 2p, 2p + 1 is one word
    const int step = kSlice / 16 * (wu / R) + lane / 4;
    const int perm = (step & 7) << 2;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int k16 = 4 * (lane & 3) + 2 * p;
      const int slot = ((step * NT + m / 8) * 32 + (((m & 7) * 4 + ((k16 & 7) >> 1)) ^ perm)) * 2 +
                       (k16 >> 3);
      const uint32_t hi = pack_bf16x2(q[2 * p], q[2 * p + 1]);
      const uint32_t lo = pack_bf16x2(q[2 * p] - __uint_as_float(hi << 16),
                                      q[2 * p + 1] - __uint_as_float(hi & 0xffff0000u));
      xhi[slot] = hi;
      xlo[slot] = lo;
      lo_bits |= lo & 0x7fff7fffu;
    }
  }
  return lo_bits != 0;
}

// R: rows a block (a multiple of 8); P = per_word * R / kWarps: units of
// 4 x values a thread stages per tile.
template <int R, int P>
__global__ void __launch_bounds__(kThreads, 2)
subbyte_t_kernel(const float* __restrict__ x, const uint32_t* __restrict__ words,
                 const uint8_t* __restrict__ scales, float* __restrict__ y,
                 int M, int N, int K, int k_pad, int width, int bs, lmq::BfpSpec aq) {
  constexpr int NT = R / 8;  // n8 tiles of rows
  extern __shared__ __align__(16) uint8_t smem_k1[];
  const int per_word = 32 / width;
  const int tile = per_word * kSlice;
  const int nsb = tile / bs;  // scale rows per tile
  const int slot_bytes = k1_slot_bytes(nsb);
  uint8_t* ring = smem_k1;                                            // [kK1Stages] slots
  uint32_t* xs = reinterpret_cast<uint32_t*>(ring + kK1Stages * slot_bytes);  // [2][hi, lo][tile * R / 2]
  const uint32_t mask = (1u << width) - 1u;
  // code - cmax = float(0x4B000000 | code) - (2^23 + cmax), exactly
  const float magic = 8388608.f + (float)((1 << (width - 1)) - 1);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, tig = lane & 3;
  const int ct = warp & 1;   // this warp's 16-column tile of the block
  const int q = warp >> 1;   // and its word-row groups q and q + 4 of every tile
  const int n_lo = ct * 16 + g;  // this lane's columns n_lo and n_lo + 8
  const int col0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * R;
  const int rows = min(R, M - m0);
  const int live_nt = (rows + 7) / 8;
  const int n_tiles = k_pad / tile;

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;

#pragma unroll
  for (int s = 0; s < kK1Stages - 1; ++s) {
    if (s < n_tiles) k1_load_tile(ring + s * slot_bytes, words, scales, s, nsb, col0, N);
    cp_async_commit();
  }
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  float xv[P][4];
  k1_load_x<R, P>(xv, x, 0, m0, rows, K, vec);

  for (int t = 0; t < n_tiles; ++t) {
    // tile t's x goes into buffer t % 2, last read two tiles ago (before the
    // barrier of tile t - 1)
    uint32_t* xhi = xs + (t & 1) * tile * R;
    uint32_t* xlo = xhi + tile * R / 2;
    const bool lo_here = k1_store_x<R, P>(xhi, xlo, xv, aq);
    if (t + 1 < n_tiles) k1_load_x<R, P>(xv, x, (t + 1) * tile, m0, rows, K, vec);
    cp_async_wait<kK1Stages - 2>();  // this thread's copies of tile t have landed
    // everyone's copies and x are visible, and everyone is done with tile
    // t - 1; the lo terms run only where some row of the tile has one (a
    // zero lo adds exactly 0)
    const bool any_lo = __syncthreads_or(lo_here);
    if (t + kK1Stages - 1 < n_tiles)
      k1_load_tile(ring + ((t + kK1Stages - 1) % kK1Stages) * slot_bytes, words, scales,
                   t + kK1Stages - 1, nsb, col0, N);
    cp_async_commit();

    const uint8_t* slot = ring + (t % kK1Stages) * slot_bytes;
    const uint32_t* wt = reinterpret_cast<const uint32_t*>(slot);
    const uint8_t* es = slot + 4 * kK1TileWords;
#pragma unroll
    for (int gi = 0; gi < 2; ++gi) {
      const int r0 = (q + 4 * gi) * 16 + 2 * tig;  // word rows r0, r0+1, r0+8, r0+9
      uint32_t w[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + (i & 1) + 8 * (i >> 1);
        w[i][0] = wt[k1_word_slot(row, n_lo)];
        w[i][1] = wt[k1_word_slot(row, n_lo + 8)];
      }
      for (int j = 0; j < per_word; ++j) {
        const int sh = width * j;
        const int kr = j * kSlice + r0;  // K row in the tile of word row r0
        // scale of (word row r0 + dr, column n_lo + 8 c)
        float s[4][2];
        if (bs >= 16) {  // the 16 rows of the k-step share one scale block
          const uint8_t* e = es + (kr / bs) * kCols + n_lo;
          const float s0 = scale_from_e8(e[0]), s1 = scale_from_e8(e[8]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[i][0] = s0;
            s[i][1] = s1;
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint8_t* e = es + ((kr + (i & 1) + 8 * (i >> 1)) / bs) * kCols + n_lo;
            s[i][0] = scale_from_e8(e[0]);
            s[i][1] = scale_from_e8(e[8]);
          }
        }
        float wv[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            wv[i][c] = (__uint_as_float(((w[i][c] >> sh) & mask) | 0x4B000000u) - magic) * s[i][c];
        // A fragment: rows n_lo / n_lo + 8, k = 2 tig (+1) and 2 tig + 8 (+9)
        const uint32_t a[4] = {pack_bf16x2(wv[0][0], wv[1][0]), pack_bf16x2(wv[0][1], wv[1][1]),
                               pack_bf16x2(wv[2][0], wv[3][0]), pack_bf16x2(wv[2][1], wv[3][1])};
        const int step = kr >> 4;  // (j * kSlice + (q + 4 gi) * 16) / 16
        const int bl_lane = lane ^ ((step & 7) << 2);
        const uint2* bh = reinterpret_cast<const uint2*>(xhi) + step * NT * 32 + bl_lane;
        const uint2* bl = reinterpret_cast<const uint2*>(xlo) + step * NT * 32 + bl_lane;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt >= live_nt) break;
          mma_bf16(acc[nt], a, bh[nt * 32]);
          if (any_lo) mma_bf16(acc[nt], a, bl[nt * 32]);
        }
      }
    }
  }

  // combine the 4 word-row warps of each column tile, q = 0 first
  float* red = reinterpret_cast<float*>(xs);  // [4 q][2 ct][NT][32 lanes][4]; fits in x
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) red[(((q * 2 + ct) * NT + nt) * 32 + lane) * 4 + i] = acc[nt][i];
  __syncthreads();
  for (int o = threadIdx.x; o < R * kCols; o += kThreads) {
    const int m = o / kCols, n = o % kCols;
    if (m >= rows || col0 + n >= N) continue;
    // accumulator element of (n, m): column tile n / 16, lane (n % 8) * 4 +
    // (m % 8) / 2, register (m % 2) + 2 ((n % 16) / 8)
    const int c = n >> 4, src_lane = (n & 7) * 4 + ((m & 7) >> 1);
    const int reg = (m & 1) + 2 * ((n & 15) >> 3);
    float sum = 0.f;
    for (int w = 0; w < 4; ++w)
      sum += red[(((w * 2 + c) * NT + (m >> 3)) * 32 + src_lane) * 4 + reg];
    y[(size_t)(m0 + m) * N + col0 + n] = sum;
  }
}

// ---------------------------------------------------------------- K2

// actq_split: x [M, K] float32 -> the workspace of K2 and K3: hi [M][kw]
// and lo [M][kw] bf16 (hi = bf16(q), lo = bf16(q - hi), q = actq(x) or x
// itself, 0 past K), then lo_flags [M][kw / kSplitK] bytes (1 where a
// chunk of a row has a nonzero lo; a row has a lo where any of its chunks
// has). A block a chunk of kSplitK = 512 K of a row (kw is a multiple of
// it: 8 x 8 = 64 blocks at M = 8 and K = 4096, where one block a row left
// 124 of 132 SMs idle), a thread 4 consecutive K, so a quantizer block
// (aq.bs | 32) is held by one thread or by a run of aq.bs / 4 lanes and
// never straddles a chunk. Each block first lets the matmul launched
// behind it with PDL start (pdl_launch_dependents): its blocks queue their
// first weight stages while this kernel runs, and wait for it before they
// read the workspace. What bounds it: latency (a few hundred bytes a block),
// not its bytes.
constexpr int kSplitThreads = 128;
constexpr int kSplitK = 4 * kSplitThreads;

__global__ void __launch_bounds__(kSplitThreads)
actq_split_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ hi,
                  __nv_bfloat16* __restrict__ lo, uint8_t* __restrict__ lo_flags, int K, int kw,
                  lmq::BfpSpec aq) {
  pdl_launch_dependents();
  const int row = blockIdx.y;
  const float* xr = x + (size_t)row * K;
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  uint32_t lo_bits = 0;
  {
    const int k = blockIdx.x * kSplitK + 4 * threadIdx.x;
    float q[4];
    if (vec && k + 3 < K) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(xr + k));
      q[0] = f.x, q[1] = f.y, q[2] = f.z, q[3] = f.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) q[u] = k + u < K ? __ldg(xr + k + u) : 0.f;
    }
    if (aq.on) {
      float a[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = fabsf(q[u]);
      if (aq.bs >= 2) {
        a[0] = a[1] = fmaxf(a[0], a[1]);
        a[2] = a[3] = fmaxf(a[2], a[3]);
      }
      if (aq.bs >= 4) a[0] = a[1] = a[2] = a[3] = fmaxf(a[0], a[2]);
      for (int o = 1; o < aq.bs / 4; o <<= 1)
        a[0] = a[1] = a[2] = a[3] = fmaxf(a[0], __shfl_xor_sync(0xffffffffu, a[0], o));
#pragma unroll
      for (int u = 0; u < 4; ++u) q[u] = lmq::bfp_qdq(q[u], a[u], aq);
    }
    uint32_t h[2], l[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      h[p] = pack_bf16x2(q[2 * p], q[2 * p + 1]);
      l[p] = pack_bf16x2(q[2 * p] - __uint_as_float(h[p] << 16),
                         q[2 * p + 1] - __uint_as_float(h[p] & 0xffff0000u));
      lo_bits |= l[p] & 0x7fff7fffu;  // a -0 lo adds nothing either
    }
    *reinterpret_cast<uint2*>(hi + (size_t)row * kw + k) = make_uint2(h[0], h[1]);
    *reinterpret_cast<uint2*>(lo + (size_t)row * kw + k) = make_uint2(l[0], l[1]);
  }
  const int any = __syncthreads_or(lo_bits != 0);
  if (threadIdx.x == 0) lo_flags[(size_t)row * gridDim.x + blockIdx.x] = any ? 1 : 0;
}

// Whether any of `rows` rows from m0 has a lo term: an OR over their chunk
// flags (nck a row), by the whole block.
__device__ __forceinline__ bool rows_have_lo(const uint8_t* __restrict__ lo_flags, int m0,
                                             int rows, int nck) {
  bool mine = false;
  for (int i = threadIdx.x; i < rows * nck; i += kThreads)
    mine |= lo_flags[(size_t)m0 * nck + i] != 0;
  return __syncthreads_or(mine);
}

// int8_kernel: y [M, N] = (hi + lo) . (codes * scales)^T on the tensor
// cores. COLS output columns a block (16 or 32: one or two 16-row mma
// tiles), R rows a block (8 or 16: one or two n8 tiles). PC (bs 1 and 2):
// a scale a code, read from L2 where it is applied; the ring holds no
// scales. Warp w takes the column tile w % NCT and the K group w / NCT:
// 64 K of every ring stage, four k16 steps. Within a group a thread's 16
// consecutive K of a row (one 16-byte load of codes, two of x) feed the
// four steps: step s uses K 4s .. 4s + 3 of them as the mma's k 2 tig, +1,
// 2 tig + 8, +9, the same permutation of K for A and B, so the products are
// the same.
constexpr int kK2Stages = 4;     // ring stages in flight
constexpr int kK2WarpK = 64;     // K of a warp's share of a stage
constexpr int kK2WsK = 512;      // the workspace's K stride is a multiple of this
// int8 code times a power-of-two scale is exact in bf16 from this scale up
// (bf16 subnormals are multiples of 2^-133); a scale below it is applied
// as s * 2^64 in the mma and 2^-64 in float32
constexpr float kK2Bf16Scale = 0x1p-133f;
constexpr float kK2Lift = 0x1p64f, kK2Drop = 0x1p-64f;

template <int COLS>
struct K2Tile {
  static constexpr int NCT = COLS / 16;          // 16-column mma tiles
  static constexpr int KG = kWarps / NCT;        // K groups of warps
  static constexpr int KT = KG * kK2WarpK;       // K of a ring stage: 256 or 512
  static constexpr int CSTR = KT + 64;           // bytes of a code row in a slot
  static constexpr int XSTR = KT + 8;            // bf16 of an x row in a slot
};

template <bool PC>
__host__ __device__ __forceinline__ int k2_sstr(int kt, int lbs) {
  return PC ? 0 : (kt >> lbs) + 4;
}

// A ring slot: codes [COLS][CSTR] bytes, x hi [R][XSTR] bf16, scales
// [COLS][sstr] float32 (none for PC). The row strides spread a warp's
// 16-byte loads over all banks (codes: rows 64 bytes apart mod 128; x: 16).
template <int COLS, int R, bool PC>
__host__ __device__ __forceinline__ int k2_slot_bytes(int lbs) {
  using T = K2Tile<COLS>;
  return COLS * T::CSTR + 2 * R * T::XSTR + 4 * COLS * k2_sstr<PC>(T::KT, lbs);
}

// Queue stage t (K t*KT ..) of the block's x hi into `slot`, zero past the
// live rows (16-byte copies: kw is a multiple of KT).
template <int COLS, int R>
__device__ __forceinline__ void k2_load_x(uint8_t* slot, const __nv_bfloat16* __restrict__ xhi,
                                          int t, int m0, int M, int kw) {
  using T = K2Tile<COLS>;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(slot + COLS * T::CSTR);
  for (int i = threadIdx.x; i < R * T::KT / 8; i += kThreads) {
    const int r = i / (T::KT / 8), c = 8 * (i % (T::KT / 8));
    const bool in = m0 + r < M;
    cp_async16(xs + r * T::XSTR + c, in ? xhi + (size_t)(m0 + r) * kw + t * T::KT + c : xhi,
               in ? 16 : 0);
  }
}

// Queue stage t (K t*KT ..) of the block's codes and scales into `slot`,
// zero past N and past k_pad: 16-byte copies where the rows allow them,
// else 4-byte ones (codes at bs 1 and 2 with k_pad off 4 bytes: a byte at
// a time). They do not depend on x: the first stages are queued before the
// kernel waits for actq_split.
template <int COLS, int R, bool PC>
__device__ __forceinline__ void k2_load_weights(uint8_t* slot, const int8_t* __restrict__ codes,
                                                const float* __restrict__ scales, int t, int col0,
                                                int N, int k_pad, int lbs, bool codes16,
                                                bool scales16) {
  using T = K2Tile<COLS>;
  const int k0 = t * T::KT;
  if (codes16) {
    for (int i = threadIdx.x; i < COLS * T::KT / 16; i += kThreads) {
      const int r = i / (T::KT / 16), c = 16 * (i % (T::KT / 16));
      const bool in = col0 + r < N && k0 + c < k_pad;
      cp_async16(slot + r * T::CSTR + c, in ? codes + (size_t)(col0 + r) * k_pad + k0 + c : codes,
                 in ? 16 : 0);
    }
  } else if (PC && k_pad % 4) {  // rows off 4 bytes (bs 1 and 2 only): a byte at a time
    for (int i = threadIdx.x; i < COLS * T::KT; i += kThreads) {
      const int r = i / T::KT, c = i % T::KT;
      const bool in = col0 + r < N && k0 + c < k_pad;
      slot[r * T::CSTR + c] = in ? (uint8_t)codes[(size_t)(col0 + r) * k_pad + k0 + c] : 0;
    }
  } else {
    for (int i = threadIdx.x; i < COLS * T::KT / 4; i += kThreads) {
      const int r = i / (T::KT / 4), c = 4 * (i % (T::KT / 4));
      const bool in = col0 + r < N && k0 + c < k_pad;
      cp_async4(slot + r * T::CSTR + c, in ? codes + (size_t)(col0 + r) * k_pad + k0 + c : codes,
                in ? 4 : 0);
    }
  }
  if (PC) return;  // the scales come from L2 where they are applied
  float* ss = reinterpret_cast<float*>(slot + COLS * T::CSTR + 2 * R * T::XSTR);
  const int spr = T::KT >> lbs, sstr = spr + 4, nb = k_pad >> lbs, s0 = k0 >> lbs;
  if (scales16) {
    for (int i = threadIdx.x; i < COLS * spr / 4; i += kThreads) {
      const int r = i / (spr / 4), c = 4 * (i % (spr / 4));
      const bool in = col0 + r < N && s0 + c < nb;
      cp_async16(ss + r * sstr + c, in ? scales + (size_t)(col0 + r) * nb + s0 + c : scales,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < COLS * spr; i += kThreads) {
      const int r = i / spr, c = i % spr;
      const bool in = col0 + r < N && s0 + c < nb;
      cp_async4(ss + r * sstr + c, in ? scales + (size_t)(col0 + r) * nb + s0 + c : scales,
                in ? 4 : 0);
    }
  }
}

// code j of a word of four int8 codes, as float: 2^23 + (code + 128),
// built from bits, minus 2^23 + 128, exactly
__device__ __forceinline__ float k2_code(uint32_t biased, int j) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + j)) - 8388736.f;
}

// The A fragment of step s: rows n_lo (c0) and n_lo + 8 (c1), their codes
// 4s .. 4s + 3 (words wd0, wd1, biased by 0x80 a byte) times scales s0, s1.
__device__ __forceinline__ void k2_a_frag(uint32_t (&a)[4], uint32_t wd0, uint32_t wd1, float s0,
                                          float s1) {
  a[0] = pack_bf16x2(k2_code(wd0, 0) * s0, k2_code(wd0, 1) * s0);
  a[1] = pack_bf16x2(k2_code(wd1, 0) * s1, k2_code(wd1, 1) * s1);
  a[2] = pack_bf16x2(k2_code(wd0, 2) * s0, k2_code(wd0, 3) * s0);
  a[3] = pack_bf16x2(k2_code(wd1, 2) * s1, k2_code(wd1, 3) * s1);
}

// The A fragment of step s with a scale a code: rows n_lo (c0, scales
// s0[0..3]) and n_lo + 8 (c1, s1[0..3]).
__device__ __forceinline__ void k2_a_frag_pc(uint32_t (&a)[4], uint32_t wd0, uint32_t wd1,
                                             const float (&s0)[4], const float (&s1)[4]) {
  a[0] = pack_bf16x2(k2_code(wd0, 0) * s0[0], k2_code(wd0, 1) * s0[1]);
  a[1] = pack_bf16x2(k2_code(wd1, 0) * s1[0], k2_code(wd1, 1) * s1[1]);
  a[2] = pack_bf16x2(k2_code(wd0, 2) * s0[2], k2_code(wd0, 3) * s0[3]);
  a[3] = pack_bf16x2(k2_code(wd1, 2) * s1[2], k2_code(wd1, 3) * s1[3]);
}

// 3 blocks an SM where 3 rings fit (32 columns, 8 rows: 66 KB a block at
// blocks of 16; ptxas then holds it to 80 registers), else 2
template <int COLS, int R, bool PC>
__global__ void __launch_bounds__(kThreads, COLS == 32 && R == 8 ? 3 : 2)
int8_kernel(const __nv_bfloat16* __restrict__ xhi, const __nv_bfloat16* __restrict__ xlo,
            const uint8_t* __restrict__ lo_flags, const int8_t* __restrict__ codes,
            const float* __restrict__ scales, float* __restrict__ y, int M, int N, int k_pad,
            int kw, int lbs, bool codes16, bool scales16) {
  using T = K2Tile<COLS>;
  constexpr int NT = R / 8;
  extern __shared__ __align__(16) uint8_t smem_k2[];
  const int slot_bytes = k2_slot_bytes<COLS, R, PC>(lbs);
  const int sstr = k2_sstr<PC>(T::KT, lbs);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, tig = lane & 3;
  const int ct = warp % T::NCT, q = warp / T::NCT;
  const int n_lo = ct * 16 + g;                 // this lane's columns n_lo and n_lo + 8
  const int kb = q * kK2WarpK + 16 * tig;       // and its 16 K of every stage
  const int m0 = blockIdx.x * R, col0 = blockIdx.y * COLS;
  const int rows = min(R, M - m0);
  const int live_nt = (rows + 7) / 8;
  const int n_tiles = (k_pad + T::KT - 1) / T::KT;

  // the first stages' codes and scales, then (after actq_split, where it
  // runs before this kernel under PDL) their x, each stage's x in a copy
  // group of its own: stage s's copies have landed once group s has
#pragma unroll
  for (int s = 0; s < kK2Stages - 1; ++s)
    if (s < n_tiles)
      k2_load_weights<COLS, R, PC>(smem_k2 + s * slot_bytes, codes, scales, s, col0, N, k_pad,
                                   lbs, codes16, scales16);
  pdl_wait();
  // the lo products run only where some row of the block has a lo term (a
  // zero lo adds exactly 0 to the others)
  const bool any_lo = rows_have_lo(lo_flags, m0, rows, kw / kSplitK);
#pragma unroll
  for (int s = 0; s < kK2Stages - 1; ++s) {
    if (s < n_tiles) k2_load_x<COLS, R>(smem_k2 + s * slot_bytes, xhi, s, m0, M, kw);
    cp_async_commit();
  }

  float acc[NT][4], fix[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = fix[nt][i] = 0.f;
  bool fixed = false;  // warp-uniform: some scale of this warp was below kK2Bf16Scale

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kK2Stages - 2>();  // this thread's copies of stage t have landed
    __syncthreads();                 // everyone's have, and everyone is done with t - 1
    const int nxt = t + kK2Stages - 1;
    if (nxt < n_tiles) {
      uint8_t* slot = smem_k2 + (nxt % kK2Stages) * slot_bytes;
      k2_load_weights<COLS, R, PC>(slot, codes, scales, nxt, col0, N, k_pad, lbs, codes16,
                                   scales16);
      k2_load_x<COLS, R>(slot, xhi, nxt, m0, M, kw);
    }
    cp_async_commit();

    const uint8_t* slot = smem_k2 + (t % kK2Stages) * slot_bytes;
    const uint4 c0 = *reinterpret_cast<const uint4*>(slot + n_lo * T::CSTR + kb);
    const uint4 c1 = *reinterpret_cast<const uint4*>(slot + (n_lo + 8) * T::CSTR + kb);
    const uint32_t w0[4] = {c0.x ^ 0x80808080u, c0.y ^ 0x80808080u, c0.z ^ 0x80808080u,
                            c0.w ^ 0x80808080u};
    const uint32_t w1[4] = {c1.x ^ 0x80808080u, c1.y ^ 0x80808080u, c1.z ^ 0x80808080u,
                            c1.w ^ 0x80808080u};
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(slot + COLS * T::CSTR);
    const float* ss = reinterpret_cast<const float*>(slot + COLS * T::CSTR + 2 * R * T::XSTR);
    // B: row (column of the mma) nt * 8 + g, this lane's 16 K: 8 bf16x2 words
    uint32_t bh[NT][8], bl[NT][8];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint4* src = reinterpret_cast<const uint4*>(xs + (nt * 8 + g) * T::XSTR + kb);
      const uint4 u0 = src[0], u1 = src[1];
      bh[nt][0] = u0.x, bh[nt][1] = u0.y, bh[nt][2] = u0.z, bh[nt][3] = u0.w;
      bh[nt][4] = u1.x, bh[nt][5] = u1.y, bh[nt][6] = u1.z, bh[nt][7] = u1.w;
    }
    if (any_lo) {  // straight from the workspace (in L2 after actq_split)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int m = m0 + nt * 8 + g;
        uint4 u0 = make_uint4(0, 0, 0, 0), u1 = u0;
        if (nt < live_nt && m < M) {
          const uint4* src = reinterpret_cast<const uint4*>(xlo + (size_t)m * kw + t * T::KT + kb);
          u0 = __ldg(src);
          u1 = __ldg(src + 1);
        }
        bl[nt][0] = u0.x, bl[nt][1] = u0.y, bl[nt][2] = u0.z, bl[nt][3] = u0.w;
        bl[nt][4] = u1.x, bl[nt][5] = u1.y, bl[nt][6] = u1.z, bl[nt][7] = u1.w;
      }
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if constexpr (PC) {
        // a scale a code (bs 1 or 2), from L2; 0 past N and past k_pad,
        // where the codes are 0 too
        const int nb = k_pad >> lbs, k = t * T::KT + kb + 4 * s;
        float s0[4], s1[4], a0[4], a1[4], f0[4], f1[4];
        bool tiny = false;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int si = (k + j) >> lbs;
          const bool in = si < nb;
          s0[j] = in && col0 + n_lo < N ? __ldg(scales + (size_t)(col0 + n_lo) * nb + si) : 0.f;
          s1[j] = in && col0 + n_lo + 8 < N ? __ldg(scales + (size_t)(col0 + n_lo + 8) * nb + si)
                                            : 0.f;
          const bool t0 = s0[j] > 0.f && s0[j] < kK2Bf16Scale;
          const bool t1 = s1[j] > 0.f && s1[j] < kK2Bf16Scale;
          a0[j] = t0 ? 0.f : s0[j], a1[j] = t1 ? 0.f : s1[j];
          f0[j] = t0 ? s0[j] * kK2Lift : 0.f, f1[j] = t1 ? s1[j] * kK2Lift : 0.f;
          tiny |= t0 || t1;
        }
        uint32_t a[4];
        k2_a_frag_pc(a, w0[s], w1[s], a0, a1);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt >= live_nt) break;
          mma_bf16(acc[nt], a, make_uint2(bh[nt][2 * s], bh[nt][2 * s + 1]));
          if (any_lo) mma_bf16(acc[nt], a, make_uint2(bl[nt][2 * s], bl[nt][2 * s + 1]));
        }
        if (__any_sync(0xffffffffu, tiny)) {
          fixed = true;
          k2_a_frag_pc(a, w0[s], w1[s], f0, f1);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (nt >= live_nt) break;
            mma_bf16(fix[nt], a, make_uint2(bh[nt][2 * s], bh[nt][2 * s + 1]));
            if (any_lo) mma_bf16(fix[nt], a, make_uint2(bl[nt][2 * s], bl[nt][2 * s + 1]));
          }
        }
        continue;
      }
      const int si = (kb + 4 * s) >> lbs;  // 4 | bs: one scale a row and step
      float s0 = ss[n_lo * sstr + si], s1 = ss[(n_lo + 8) * sstr + si];
      const bool t0 = s0 > 0.f && s0 < kK2Bf16Scale, t1 = s1 > 0.f && s1 < kK2Bf16Scale;
      uint32_t a[4];
      k2_a_frag(a, w0[s], w1[s], t0 ? 0.f : s0, t1 ? 0.f : s1);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt >= live_nt) break;
        mma_bf16(acc[nt], a, make_uint2(bh[nt][2 * s], bh[nt][2 * s + 1]));
        if (any_lo) mma_bf16(acc[nt], a, make_uint2(bl[nt][2 * s], bl[nt][2 * s + 1]));
      }
      if (__any_sync(0xffffffffu, t0 || t1)) {
        fixed = true;
        k2_a_frag(a, w0[s], w1[s], t0 ? s0 * kK2Lift : 0.f, t1 ? s1 * kK2Lift : 0.f);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt >= live_nt) break;
          mma_bf16(fix[nt], a, make_uint2(bh[nt][2 * s], bh[nt][2 * s + 1]));
          if (any_lo) mma_bf16(fix[nt], a, make_uint2(bl[nt][2 * s], bl[nt][2 * s + 1]));
        }
      }
    }
  }

  // combine the K groups of each column tile, q = 0 first
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_k2);  // [KG][NCT][NT][32 lanes][4]; fits in a slot
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      red[(((q * T::NCT + ct) * NT + nt) * 32 + lane) * 4 + i] =
          fixed ? acc[nt][i] + fix[nt][i] * kK2Drop : acc[nt][i];
  __syncthreads();
  for (int o = threadIdx.x; o < R * COLS; o += kThreads) {
    const int m = o / COLS, n = o % COLS;
    if (m >= rows || col0 + n >= N) continue;
    // accumulator element of (n, m): as in K1
    const int c = n >> 4, src_lane = (n & 7) * 4 + ((m & 7) >> 1);
    const int reg = (m & 1) + 2 * ((n & 15) >> 3);
    float sum = 0.f;
    for (int w = 0; w < T::KG; ++w)
      sum += red[(((w * T::NCT + c) * NT + (m >> 3)) * 32 + src_lane) * 4 + reg];
    y[(size_t)(m0 + m) * N + col0 + n] = sum;
  }
}

// ---------------------------------------------------------------- K3

// subbyte_kernel: y [M, N] = (hi + lo) . deq(W)^T on the tensor cores, W
// lane-major sub-byte words. COLS output columns a block (16 or 32: one or
// two 16-row mma tiles), R rows a block (8 or 16: one or two n8 tiles).
// Warp w takes the column tile w % NCT and the 16-row word groups
// (w / NCT) * GPW .. + GPW - 1 of every packing tile.
constexpr int kK3Stages = 4;  // ring stages in flight, at most
// shared memory of an SM, and the bytes the runtime keeps of it a block
constexpr int kSmemSm = 228 * 1024, kSmemBlockReserve = 1024;

template <int COLS>
struct K3Tile {
  static constexpr int NCT = COLS / 16;          // 16-column mma tiles
  static constexpr int KG = kWarps / NCT;        // word-row groups of warps: 4 or 8
  static constexpr int GPW = kSlice / 16 / KG;   // 16-row groups of a warp a tile: 2 or 1
};

// bf16 of an x row in a slot: rows 32 bytes apart mod 128, so the 8-byte B
// loads of a half-warp (4 rows, 32 bytes each) take every bank once
__host__ __device__ __forceinline__ int k3_xstr(int tile) { return tile + 16; }

// A ring slot: words [COLS][kSlice], x hi [R][xstr] bf16, scale bytes
// [COLS][nsb] rounded up to 16.
__host__ __device__ __forceinline__ int k3_slot_bytes(int cols, int rows, int tile, int nsb) {
  return cols * kSlice * 4 + rows * k3_xstr(tile) * 2 + (cols * nsb + 15) / 16 * 16;
}

// Word (row, col) of a slot: a column's words in order, the 16-word halves
// of each 32 swapped on odd columns, so that the 16-byte A loads of a
// quarter-warp (two columns, 64 bytes each) take every bank once.
__device__ __forceinline__ int k3_word_slot(int row, int col) {
  return col * kSlice + (row ^ ((col & 1) << 4));
}

// Queue packing tile t of the block's x hi into `slot`, zero past the
// live rows.
template <int COLS, int R>
__device__ __forceinline__ void k3_load_x(uint8_t* slot, const __nv_bfloat16* __restrict__ xhi,
                                          int t, int m0, int M, int tile, int kw) {
  const int xstr = k3_xstr(tile);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(slot + COLS * kSlice * 4);
  for (int i = threadIdx.x; i < R * tile / 8; i += kThreads) {
    const int r = i / (tile / 8), c = 8 * (i % (tile / 8));
    const bool in = m0 + r < M;
    cp_async16(xs + r * xstr + c, in ? xhi + (size_t)(m0 + r) * kw + (size_t)t * tile + c : xhi,
               in ? 16 : 0);
  }
}

// Queue packing tile t of the block's words and scale bytes into `slot`,
// zero past N. Words: 16-byte copies where the buffer is 16-byte aligned,
// else 4-byte ones. Scales: the block's columns of tile t are one run of
// COLS * nsb bytes, copied in pieces of smode bytes (16 or 4 where every
// run is so aligned, else plain loads). They do not depend on x: the first
// stages are queued before the kernel waits for actq_split.
template <int COLS, int R>
__device__ __forceinline__ void k3_load_weights(uint8_t* slot, const uint32_t* __restrict__ words,
                                                const uint8_t* __restrict__ scales, int t,
                                                int col0, int N, int n_words, int tile, int nsb,
                                                bool words16, int smode) {
  uint32_t* dw = reinterpret_cast<uint32_t*>(slot);
  const uint32_t* src = words + (size_t)col0 * n_words + (size_t)t * kSlice;
  if (words16) {
    for (int i = threadIdx.x; i < COLS * kSlice / 4; i += kThreads) {
      const int c = i / (kSlice / 4), row = 4 * (i % (kSlice / 4));
      const bool in = col0 + c < N;
      cp_async16(dw + k3_word_slot(row, c), in ? src + (size_t)c * n_words + row : words,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < COLS * kSlice; i += kThreads) {
      const int c = i / kSlice, row = i % kSlice;
      const bool in = col0 + c < N;
      cp_async4(dw + k3_word_slot(row, c), in ? src + (size_t)c * n_words + row : words,
                in ? 4 : 0);
    }
  }
  uint8_t* ss = slot + COLS * kSlice * 4 + R * k3_xstr(tile) * 2;
  const uint8_t* ssrc = scales + ((size_t)t * N + col0) * nsb;
  const int total = COLS * nsb, valid = min(COLS, N - col0) * nsb;
  if (smode == 16) {
    for (int o = 16 * threadIdx.x; o < total; o += 16 * kThreads) {
      const int v = max(0, min(16, valid - o));
      cp_async16(ss + o, v ? ssrc + o : scales, v);
    }
  } else if (smode == 4) {
    for (int o = 4 * threadIdx.x; o < total; o += 4 * kThreads) {
      const int v = max(0, min(4, valid - o));
      cp_async4(ss + o, v ? ssrc + o : scales, v);
    }
  } else {
    for (int i = threadIdx.x; i < total; i += kThreads) ss[i] = i < valid ? __ldg(ssrc + i) : 0;
  }
}

// wait until at most stages - 2 groups of this thread's copies are pending
__device__ __forceinline__ void k3_wait_ring(int stages) {
  if (stages >= 4) cp_async_wait<2>();
  else if (stages == 3) cp_async_wait<1>();
  else cp_async_wait<0>();
}

// code at bit `sh` of a word, minus cmax, times a power-of-two scale:
// float(0x4B000000 | code) = 2^23 + code, minus magic = 2^23 + cmax, exactly
__device__ __forceinline__ float k3_deq(uint32_t word, int sh, uint32_t mask, float magic,
                                        float s) {
  return (__uint_as_float(((word >> sh) & mask) | 0x4B000000u) - magic) * s;
}

template <int COLS, int R>
__global__ void __launch_bounds__(kThreads, 2)
subbyte_kernel(const __nv_bfloat16* __restrict__ xhi, const __nv_bfloat16* __restrict__ xlo,
               const uint8_t* __restrict__ lo_flags, const uint32_t* __restrict__ words,
               const uint8_t* __restrict__ scales, float* __restrict__ y, int M, int N,
               int k_pad, int kw, int width, int lbs, int stages, bool words16, int smode) {
  using T = K3Tile<COLS>;
  constexpr int NT = R / 8;
  extern __shared__ __align__(16) uint8_t smem_k3[];
  const int per_word = 32 / width;
  const int tile = per_word * kSlice;
  const int nsb = tile >> lbs;  // scale bytes of a column and tile
  const int n_tiles = k_pad / tile;
  const int n_words = n_tiles * kSlice;
  const int xstr = k3_xstr(tile);
  const int slot_bytes = k3_slot_bytes(COLS, R, tile, nsb);
  const uint32_t mask = (1u << width) - 1u;
  const float magic = 8388608.f + (float)((1 << (width - 1)) - 1);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, tig = lane & 3;
  const int ct = warp % T::NCT, q = warp / T::NCT;
  const int n_lo = ct * 16 + g;  // this lane's columns n_lo and n_lo + 8
  const int m0 = blockIdx.x * R, col0 = blockIdx.y * COLS;
  const int rows = min(R, M - m0);
  const int live_nt = (rows + 7) / 8;

  // the first stages' words and scales, then (after actq_split, where it
  // runs before this kernel under PDL) their x, each stage's x in a copy
  // group of its own: stage s's copies have landed once group s has
  for (int s = 0; s < stages - 1; ++s)
    if (s < n_tiles)
      k3_load_weights<COLS, R>(smem_k3 + s * slot_bytes, words, scales, s, col0, N, n_words,
                               tile, nsb, words16, smode);
  pdl_wait();
  // the lo products run only where some row of the block has a lo term (a
  // zero lo adds exactly 0 to the others)
  const bool any_lo = rows_have_lo(lo_flags, m0, rows, kw / kSplitK);
  for (int s = 0; s < stages - 1; ++s) {
    if (s < n_tiles) k3_load_x<COLS, R>(smem_k3 + s * slot_bytes, xhi, s, m0, M, tile, kw);
    cp_async_commit();
  }

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    k3_wait_ring(stages);  // this thread's copies of tile t have landed
    __syncthreads();       // everyone's have, and everyone is done with t - 1
    const int nxt = t + stages - 1;
    if (nxt < n_tiles) {
      uint8_t* slot = smem_k3 + (nxt % stages) * slot_bytes;
      k3_load_weights<COLS, R>(slot, words, scales, nxt, col0, N, n_words, tile, nsb, words16,
                               smode);
      k3_load_x<COLS, R>(slot, xhi, nxt, m0, M, tile, kw);
    }
    cp_async_commit();

    const uint8_t* slot = smem_k3 + (t % stages) * slot_bytes;
    const uint32_t* wt = reinterpret_cast<const uint32_t*>(slot);
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(slot + COLS * kSlice * 4);
    const uint8_t* e0 = slot + COLS * kSlice * 4 + R * xstr * 2 + n_lo * nsb;  // column n_lo
    const uint8_t* e1 = e0 + 8 * nsb;                                          // and n_lo + 8
#pragma unroll
    for (int gi = 0; gi < T::GPW; ++gi) {
      const int r0 = (q * T::GPW + gi) * 16 + 4 * tig;  // this lane's word rows r0 .. r0 + 3
      const uint4 w0 = *reinterpret_cast<const uint4*>(wt + k3_word_slot(r0, n_lo));
      const uint4 w1 = *reinterpret_cast<const uint4*>(wt + k3_word_slot(r0, n_lo + 8));
      for (int j = 0; j < per_word; ++j) {
        const int sh = width * j;
        const int kk = j * kSlice + r0;  // K row in the tile of word row r0, slice j
        float s0[4], s1[4];  // scales of K rows kk .. kk + 3 of the two columns
        if (lbs >= 2) {
          const float a0 = scale_from_e8(e0[kk >> lbs]), a1 = scale_from_e8(e1[kk >> lbs]);
#pragma unroll
          for (int u = 0; u < 4; ++u) s0[u] = a0, s1[u] = a1;
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            s0[u] = scale_from_e8(e0[(kk + u) >> lbs]);
            s1[u] = scale_from_e8(e1[(kk + u) >> lbs]);
          }
        }
        // A: rows n_lo / n_lo + 8; K rows kk, kk + 1 at k 2 tig (+1), kk + 2,
        // kk + 3 at k 2 tig + 8 (+9)
        const uint32_t a[4] = {
            pack_bf16x2(k3_deq(w0.x, sh, mask, magic, s0[0]), k3_deq(w0.y, sh, mask, magic, s0[1])),
            pack_bf16x2(k3_deq(w1.x, sh, mask, magic, s1[0]), k3_deq(w1.y, sh, mask, magic, s1[1])),
            pack_bf16x2(k3_deq(w0.z, sh, mask, magic, s0[2]), k3_deq(w0.w, sh, mask, magic, s0[3])),
            pack_bf16x2(k3_deq(w1.z, sh, mask, magic, s1[2]), k3_deq(w1.w, sh, mask, magic, s1[3]))};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt >= live_nt) break;
          // B: x row nt * 8 + g at K rows kk .. kk + 3, in the same order
          mma_bf16(acc[nt], a, *reinterpret_cast<const uint2*>(xs + (nt * 8 + g) * xstr + kk));
          if (any_lo) {  // straight from the workspace (in L2 after actq_split)
            const int m = m0 + nt * 8 + g;
            const uint2 bl = m < M ? __ldg(reinterpret_cast<const uint2*>(
                                         xlo + (size_t)m * kw + (size_t)t * tile + kk))
                                   : make_uint2(0u, 0u);
            mma_bf16(acc[nt], a, bl);
          }
        }
      }
    }
  }

  // combine the word-row groups of each column tile, q = 0 first
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_k3);  // [KG][NCT][NT][32 lanes][4]; fits in 2 slots
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) red[(((q * T::NCT + ct) * NT + nt) * 32 + lane) * 4 + i] = acc[nt][i];
  __syncthreads();
  for (int o = threadIdx.x; o < R * COLS; o += kThreads) {
    const int m = o / COLS, n = o % COLS;
    if (m >= rows || col0 + n >= N) continue;
    // accumulator element of (n, m): as in K1
    const int c = n >> 4, src_lane = (n & 7) * 4 + ((m & 7) >> 1);
    const int reg = (m & 1) + 2 * ((n & 15) >> 3);
    float sum = 0.f;
    for (int w = 0; w < T::KG; ++w)
      sum += red[(((w * T::NCT + c) * NT + (m >> 3)) * 32 + src_lane) * 4 + reg];
    y[(size_t)(m0 + m) * N + col0 + n] = sum;
  }
}

template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Launch a matmul that reads actq_split's workspace: with `pdl`, as a
// programmatic dependent of the kernel before it on the stream (its blocks
// queue their first weight stages while actq_split runs, and wait for it
// before they read the workspace); else as an ordinary launch (the
// workspace is filled already). Returns the launch's error, 0 if none.
template <typename... Params, typename... Args>
int launch_after_split(void (*kernel)(Params...), dim3 grid, int smem, cudaStream_t stream,
                       bool pdl, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

int k1_smem_bytes(int R, int width, int bs) {
  const int tile = (32 / width) * kSlice;
  return kK1Stages * k1_slot_bytes(tile / bs) + 2 * 2 * 2 * tile * R;
}

template <int R, int P>
int launch_subbyte_t(const void* x, const void* words, const void* scales, void* y,
                     int M, int N, int K, int k_pad, int width, int bs, lmq::BfpSpec aq,
                     cudaStream_t stream) {
  const int tile = (32 / width) * kSlice;
  const int smem = k1_smem_bytes(R, width, bs);
  if (smem > kSmemMax || k_pad % tile || (32 / width) * R / kWarps != P)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_dynamic_smem(subbyte_t_kernel<R, P>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kCols - 1) / kCols, (M + R - 1) / R);
  subbyte_t_kernel<R, P><<<grid, kThreads, smem, stream>>>(
      (const float*)x, (const uint32_t*)words, (const uint8_t*)scales, (float*)y,
      M, N, K, k_pad, width, bs, aq);
  return (int)cudaGetLastError();
}

// R rows a block; P = per_word * R / kWarps
template <int R>
int launch_subbyte_t_p(const void* x, const void* words, const void* scales, void* y,
                       int M, int N, int K, int k_pad, int width, int bs, lmq::BfpSpec aq,
                       cudaStream_t stream) {
#define LMQ_K1_CASE(P) \
  case P: return launch_subbyte_t<R, P>(x, words, scales, y, M, N, K, k_pad, width, bs, aq, stream);
  if constexpr (R == 8) {
    switch (32 / width) { LMQ_K1_CASE(4) LMQ_K1_CASE(5) LMQ_K1_CASE(6) LMQ_K1_CASE(8)
                          LMQ_K1_CASE(10) LMQ_K1_CASE(16) }
  } else {
    switch (32 / width * 2) { LMQ_K1_CASE(8) LMQ_K1_CASE(10) LMQ_K1_CASE(12) LMQ_K1_CASE(16) }
  }
#undef LMQ_K1_CASE
  return (int)cudaErrorInvalidValue;
}

template <int COLS, int R>
int launch_subbyte(const void* ws, const void* words, const void* scales, void* y, int M, int N,
                   int k_pad, int kw, int width, int lbs, int stages, bool pdl,
                   cudaStream_t stream) {
  const int tile = (32 / width) * kSlice;
  const int smem = stages * k3_slot_bytes(COLS, R, tile, tile >> lbs);
  if (stages < 2 || smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_dynamic_smem(subbyte_kernel<COLS, R>, smem);
  if (err != cudaSuccess) return (int)err;
  const __nv_bfloat16* hi = static_cast<const __nv_bfloat16*>(ws);
  const __nv_bfloat16* lo = hi + (size_t)M * kw;
  const uint8_t* lo_flags = reinterpret_cast<const uint8_t*>(lo + (size_t)M * kw);
  // a column's words start 512-byte aligned within the buffer (k_pad /
  // per_word is a multiple of 128); the scale runs at t * N * nsb bytes
  // (col0 * nsb is a multiple of 16)
  const bool words16 = reinterpret_cast<uintptr_t>(words) % 16 == 0;
  const long long run = (long long)N * (tile >> lbs);
  const uintptr_t sp = reinterpret_cast<uintptr_t>(scales);
  const int smode = run % 16 == 0 && sp % 16 == 0 ? 16 : run % 4 == 0 && sp % 4 == 0 ? 4 : 1;
  // rows fastest: the row blocks of a column block run together and share
  // its weights through L2
  const dim3 grid((M + R - 1) / R, (N + COLS - 1) / COLS);
  return launch_after_split(subbyte_kernel<COLS, R>, grid, smem, stream, pdl, hi, lo, lo_flags,
                            (const uint32_t*)words, (const uint8_t*)scales, (float*)y, M, N,
                            k_pad, kw, width, lbs, stages, words16, smode);
}

// Ring stages of K3 for cols columns and rows rows a block: as many as 4
// that leave every SM 2 blocks, else as many as fit one block (the caller
// takes 8 rows where 16 leave under 2).
int k3_stages(int cols, int rows, int tile, int nsb) {
  const int slot = k3_slot_bytes(cols, rows, tile, nsb);
  const int two = (kSmemSm / 2 - kSmemBlockReserve) / slot, one = kSmemMax / slot;
  const int n = two >= 2 ? two : one;
  return n < kK3Stages ? n : kK3Stages;
}

template <int COLS, int R, bool PC>
int launch_int8(const void* ws, const void* codes, const void* scales, void* y, int M, int N,
                int k_pad, int kw, int lbs, bool pdl, cudaStream_t stream) {
  using T = K2Tile<COLS>;
  const int smem = kK2Stages * k2_slot_bytes<COLS, R, PC>(lbs);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_dynamic_smem(int8_kernel<COLS, R, PC>, smem);
  if (err != cudaSuccess) return (int)err;
  const __nv_bfloat16* hi = static_cast<const __nv_bfloat16*>(ws);
  const __nv_bfloat16* lo = hi + (size_t)M * kw;
  const uint8_t* lo_flags = reinterpret_cast<const uint8_t*>(lo + (size_t)M * kw);
  const bool codes16 = k_pad % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  const bool scales16 = (T::KT >> lbs) % 4 == 0 && (k_pad >> lbs) % 4 == 0 &&
                        reinterpret_cast<uintptr_t>(scales) % 16 == 0;
  // rows fastest: the row blocks of a column block run together and share
  // its weights through L2
  const dim3 grid((M + R - 1) / R, (N + COLS - 1) / COLS);
  return launch_after_split(int8_kernel<COLS, R, PC>, grid, smem, stream, pdl, hi, lo, lo_flags,
                            (const int8_t*)codes, (const float*)scales, (float*)y, M, N, k_pad,
                            kw, lbs, codes16, scales16);
}

// ws: hi, lo [M][kw] bf16, then lo_flags [M][kw / kSplitK] bytes
int launch_actq_split(const void* x, void* ws, int M, int K, int kw, lmq::BfpSpec aq,
                      cudaStream_t stream) {
  __nv_bfloat16* hi = static_cast<__nv_bfloat16*>(ws);
  __nv_bfloat16* lo = hi + (size_t)M * kw;
  actq_split_kernel<<<dim3(kw / kSplitK, M), kSplitThreads, 0, stream>>>(
      (const float*)x, hi, lo, reinterpret_cast<uint8_t*>(lo + (size_t)M * kw), K, kw, aq);
  return (int)cudaGetLastError();
}

bool actq_ok(const lmq::BfpSpec& aq) { return !aq.on || (aq.bs >= 1 && 32 % aq.bs == 0); }

}  // namespace

extern "C" {

const char* lmq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int lmq_bfp_matmul_subbyte_t(const void* x, const void* words, const void* scales,
                             void* y, int M, int N, int K, int k_pad, int width,
                             int bs, int aq_on, int aq_bs, int aq_width,
                             int aq_emin, int aq_emax, void* stream) {
  const lmq::BfpSpec aq{aq_on, aq_bs, aq_width, aq_emin, aq_emax};
  if (width < 2 || width > 8 || bs < 1 || kSlice % bs || (aq_on && 32 % aq_bs))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  // the row block never changes a row's result (each row is its own column
  // of the mma), only how many rows share a pass over the weights
  // (16 rows a block where the x a thread holds in flight stays <= 64 floats)
  if (M > 8 && 32 / width <= 8 && k1_smem_bytes(16, width, bs) <= kSmemMax)
    return launch_subbyte_t_p<16>(x, words, scales, y, M, N, K, k_pad, width, bs, aq, s);
  return launch_subbyte_t_p<8>(x, words, scales, y, M, N, K, k_pad, width, bs, aq, s);
}

// K3: actq_split into the workspace ws (as K2's), then subbyte_kernel from
// it as its programmatic dependent, on one stream; with split = 0,
// subbyte_kernel alone on a workspace that actq_split has filled (x then
// unread).
int lmq_bfp_matmul_subbyte(const void* x, const void* words, const void* scales, void* y,
                           void* ws, int M, int N, int K, int k_pad, int kw, int width, int bs,
                           int aq_on, int aq_bs, int aq_width, int aq_emin, int aq_emax,
                           int split, void* stream) {
  const lmq::BfpSpec aq{aq_on, aq_bs, aq_width, aq_emin, aq_emax};
  int lbs = 0;
  while ((1 << lbs) < bs) ++lbs;
  if (width < 2 || width > 8) return (int)cudaErrorInvalidValue;
  const int tile = (32 / width) * kSlice;
  if (bs < 1 || kSlice % bs || k_pad % tile || K > k_pad || k_pad > kw || kw % kK2WsK || M < 1 ||
      N < 1 || !actq_ok(aq))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const bool pdl = split != 0;
  if (pdl) {
    const int rc = launch_actq_split(x, ws, M, K, kw, aq, s);
    if (rc) return rc;
  }
  // columns a block by N alone, as K2; rows a block by M (a row's sums do
  // not depend on it), 8 where 16 would leave under 2 stages
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const bool wide = (N + 31) / 32 >= 2 * sms;
  const int cols = wide ? 32 : 16, nsb = tile >> lbs;
  const bool rows16 = M > 8 && k3_stages(cols, 16, tile, nsb) >= 2;
  const int stages = k3_stages(cols, rows16 ? 16 : 8, tile, nsb);
  const auto run = rows16 ? (wide ? &launch_subbyte<32, 16> : &launch_subbyte<16, 16>)
                         : (wide ? &launch_subbyte<32, 8> : &launch_subbyte<16, 8>);
  return run(ws, words, scales, y, M, N, k_pad, kw, width, lbs, stages, pdl, s);
}

int lmq_actq_split(const void* x, void* ws, int M, int K, int kw, int aq_on, int aq_bs,
                   int aq_width, int aq_emin, int aq_emax, void* stream) {
  const lmq::BfpSpec aq{aq_on, aq_bs, aq_width, aq_emin, aq_emax};
  if (M < 1 || K > kw || kw % kK2WsK || !actq_ok(aq)) return (int)cudaErrorInvalidValue;
  return launch_actq_split(x, ws, M, K, kw, aq, static_cast<cudaStream_t>(stream));
}

// K2: actq_split into the workspace ws (hi, lo [M][kw] bf16, lo_flags
// [M][kw / 512] bytes), then int8_kernel from it as its programmatic
// dependent, on one stream; with split = 0, int8_kernel alone on a
// workspace that actq_split has filled (x then unread).
int lmq_bfp_matmul_int8(const void* x, const void* codes, const void* scales, void* y,
                        void* ws, int M, int N, int K, int k_pad, int kw, int bs,
                        int aq_on, int aq_bs, int aq_width, int aq_emin, int aq_emax,
                        int split, void* stream) {
  const lmq::BfpSpec aq{aq_on, aq_bs, aq_width, aq_emin, aq_emax};
  int lbs = 0;
  while ((1 << lbs) < bs) ++lbs;
  if (bs < 1 || kSlice % bs || k_pad % bs || K > k_pad || k_pad > kw || kw % kK2WsK || M < 1 ||
      N < 1 || !actq_ok(aq))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const bool pdl = split != 0;
  if (pdl) {
    const int rc = launch_actq_split(x, ws, M, K, kw, aq, s);
    if (rc) return rc;
  }
  // 32 columns a block where that leaves every SM at least 2 blocks, else
  // 16 (N = 4096: 256 blocks on 132 SMs); a choice by N alone, so a row's
  // sums never depend on M
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const bool wide = (N + 31) / 32 >= 2 * sms;
  const auto run =
      bs < 4  // a scale a code or a pair
          ? (M <= 8 ? (wide ? &launch_int8<32, 8, true> : &launch_int8<16, 8, true>)
                    : (wide ? &launch_int8<32, 16, true> : &launch_int8<16, 16, true>))
          : (M <= 8 ? (wide ? &launch_int8<32, 8, false> : &launch_int8<16, 8, false>)
                    : (wide ? &launch_int8<32, 16, false> : &launch_int8<16, 16, false>));
  return run(ws, codes, scales, y, M, N, k_pad, kw, lbs, pdl, s);
}

}  // extern "C"
