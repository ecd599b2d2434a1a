// Stage knock-outs of the sub-byte dequant-matmul: probes P8 and P9.
//
// P8 replaces tools/ksub.py make_tcall / tkernel, tkernel2: the transposed
//    layout (PackedBFPSubT: uint32 words [K_pad / per_word, N], uint8 scale
//    exponents [K_pad / bs, N]), which the shipping sub-byte kernel K1
//    (csrc/dequant_matmul.cu, subbyte_t_kernel) reads on this card.
// P9 replaces tools/ksub.py make_call / kernel: the lane-major layout
//    (PackedBFPSub: words [N, K_pad / per_word], scale exponents
//    [n_tiles, N, tile / bs]), read by K3 (subbyte_kernel).
// Each layout's kernel is a copy of its production kernel with stages
// knocked out; the production kernels are untouched. Variants, with the
// semantics of ksub.kernel (y[M, N] = x . w over K, float32 sums):
//   ship     w = (code - cmax) * 2^clip(e8 - 128, -126, 127)
//   stream   w = bf16(float(int32(word))) against x at the K rows of shift
//            0: the words are read and no code is extracted
//   extract  w = code - cmax, no scale
//   mulconst w = bf16((code - cmax) * 1.0078125)
//   muladd   w = float(code - cmax) with e8 - 128 added into its exponent
//            bits, 0 kept 0
//   shift2   w = the stored (biased) field read signed by shl / sar, times
//            the scale
// with x rounded to bf16 and never quantized, so the gap between ship and
// the production kernel with its activation quantizer is that quantizer.
// ksub's noconcat and lanerepeat (lane-major) and tkernel / tkernel2
// (transposed) differ from ship only in TPU lowering: they are the ship
// instance here. Every variant reads the same bytes (words, scale bytes,
// x) and stages x alike; they differ only in the arithmetic between a
// word and the product.
//
// What bounds them on an H100: as K1 and K3, the packed weight bytes over
// the 3.35 TB/s memory rate at M = 8. The transposed copy runs K1's design
// (mma.sync m16n8k16 on bf16 operands with N on the mma's 16 rows, a 3-tile
// cp.async ring for words and scale bytes, the next tile's x in registers,
// 256 threads, 2 blocks an SM); the lane-major copy runs K3's (lanes along
// K, 4 columns a warp, the next tile's words in registers, float32 FMAs).
// Both take 8 rows of x a block (ksub's M). The copies differ from their
// production kernels in x alone: no quantizer, x rounded to bf16 (and K1's
// lo term of raw float32 x dropped).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 32;                      // output columns per block
constexpr int kSlice = 128;                    // word rows of a packing tile
constexpr int kRows = 8;                       // rows of x per block
constexpr int kColsPerWarp = kCols / kWarps;   // lane-major: columns per warp
constexpr int kLaneWords = kSlice / 32;        // lane-major: words per lane, column and tile
constexpr int kStages = 3;                     // transposed: packing tiles in flight
constexpr int kTileWords = kSlice * kCols;
constexpr int kSmemMax = 227 * 1024;

enum Variant { kShip = 0, kStream, kExtract, kMulconst, kMuladd, kShift2 };
enum Layout { kTransposed = 0, kLaneMajor = 1 };

// 2^clip(e8 - 128, -126, 127), as ksub builds its scales
__device__ __forceinline__ float probe_scale(int e8) {
  return __int_as_float((min(max(e8 - 128, -126), 127) + 127) << 23);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// bf16_round of a finite v in integer arithmetic (round to nearest even on
// the 16 bits dropped). The lane-major copy rounds x with it where K3 stages
// x: there the staging sits between two barriers, on every warp's path,
// and on the card this took less time than the conversion.
__device__ __forceinline__ float bf16_round_bits(float v) {
  const uint32_t u = __float_as_uint(v);
  return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
}

// What a scale byte contributes under variant V: the scale, or for muladd
// the bits to add into a float's exponent.
template <int V>
__device__ __forceinline__ float scale_term(int e8) {
  return V == kMuladd ? __uint_as_float((uint32_t)(e8 - 128) << 23) : probe_scale(e8);
}

// The weight of one stored field under variant V (not stream), given
// cf = code - cmax as a float, the word that holds the field at bit sh and
// its block's scale_term s. The transposed kernel rounds to bf16 when it
// packs the mma operand; the lane-major one rounds where the value is not
// exact.
template <int V, bool kRoundHere>
__device__ __forceinline__ float probe_weight(float cf, uint32_t word, int sh, int width, float s) {
  if constexpr (V == kShip) {
    return cf * s;
  } else if constexpr (V == kExtract) {
    return cf;
  } else if constexpr (V == kMulconst) {
    const float v = cf * 1.0078125f;
    return kRoundHere ? bf16_round(v) : v;
  } else if constexpr (V == kMuladd) {
    return cf == 0.f ? 0.f : __int_as_float(__float_as_int(cf) + __float_as_int(s));
  } else {  // kShift2
    const int field = (int)(word << (32 - sh - width)) >> (32 - width);
    return (float)field * s;
  }
}

// ------------------------------------------------- transposed (K1's design)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// d += a . b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), d 16 x 8 float32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ int word_slot(int row, int col) {
  return row * kCols + (col ^ (((row >> 1) & 3) << 3));
}

__host__ __device__ __forceinline__ int slot_bytes_of(int nsb) {
  return 4 * kTileWords + (nsb * kCols + 15) / 16 * 16;
}

// K1's k1_load_tile: tile t's words and scale bytes of the block's columns
// into ring slot `dst`, zero past N
__device__ __forceinline__ void load_tile(uint8_t* dst, const uint32_t* __restrict__ words,
                                          const uint8_t* __restrict__ scales, int t, int nsb,
                                          int col0, int N) {
  uint32_t* dw = reinterpret_cast<uint32_t*>(dst);
  const uint32_t* src = words + (size_t)t * kSlice * N;
  if (N % 4 == 0) {
    for (int i = threadIdx.x; i < kTileWords / 4; i += kThreads) {
      const int row = i / (kCols / 4), col = 4 * (i % (kCols / 4));
      const bool in = col0 + col < N;
      cp_async16(dw + word_slot(row, col), in ? src + (size_t)row * N + col0 + col : words,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kTileWords; i += kThreads) {
      const int row = i / kCols, col = i % kCols;
      const bool in = col0 + col < N;
      cp_async4(dw + word_slot(row, col), in ? src + (size_t)row * N + col0 + col : words,
                in ? 4 : 0);
    }
  }
  uint8_t* ds = dst + 4 * kTileWords;  // [nsb][kCols]
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

// K1's k1_load_x at 8 rows: unit i of this thread is warp unit
// wu = warp + kWarps i, row wu % 8, K positions 128 (wu / 8) + 4 lane .. + 3
// of the tile; 0 past Kx and past the live rows
template <int P>
__device__ __forceinline__ void load_x(float (&v)[P][4], const float* __restrict__ x, int k0,
                                       int m0, int rows, int Kx, bool vec) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int wu = warp + kWarps * i, m = wu % kRows;
    const int k = k0 + kSlice * (wu / kRows) + 4 * lane;
    const float* src = x + (size_t)(m0 + m) * Kx + k;
    if (m >= rows || k >= Kx) {
      v[i][0] = v[i][1] = v[i][2] = v[i][3] = 0.f;
    } else if (vec && k + 3 < Kx) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(src));
      v[i][0] = f.x, v[i][1] = f.y, v[i][2] = f.z, v[i][3] = f.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) v[i][u] = k + u < Kx ? __ldg(src + u) : 0.f;
    }
  }
}

// K1's k1_store_x without the quantizer and the lo term: bf16(x) as the B
// fragments [tile / 16 k-steps][32 lanes][4 bf16], lanes XOR-permuted
template <int P>
__device__ __forceinline__ void store_x(uint32_t* xb, const float (&v)[P][4]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int wu = warp + kWarps * i, m = wu % kRows;
    const int step = kSlice / 16 * (wu / kRows) + lane / 4;
    const int perm = (step & 7) << 2;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int k16 = 4 * (lane & 3) + 2 * p;
      const int slot = (step * 32 + ((m * 4 + ((k16 & 7) >> 1)) ^ perm)) * 2 + (k16 >> 3);
      xb[slot] = pack_bf16x2(v[i][2 * p], v[i][2 * p + 1]);
    }
  }
}

// P = per_word: units of 4 x values a thread stages per tile
template <int V, int P>
__global__ void __launch_bounds__(kThreads, 2)
probe_t_kernel(const float* __restrict__ x, const uint32_t* __restrict__ words,
               const uint8_t* __restrict__ scales, float* __restrict__ y,
               int M, int N, int Kx, int k_pad, int width, int bs) {
  extern __shared__ __align__(16) uint8_t smem_t[];
  const int per_word = 32 / width;
  const int tile = per_word * kSlice;
  const int nsb = tile / bs;
  const int slot_bytes = slot_bytes_of(nsb);
  uint8_t* ring = smem_t;                                                 // [kStages] slots
  uint32_t* xs = reinterpret_cast<uint32_t*>(ring + kStages * slot_bytes);  // [2][tile * kRows / 2]
  const uint32_t mask = (1u << width) - 1u;
  // code - cmax = float(0x4B000000 | code) - (2^23 + cmax), exactly
  const float magic = 8388608.f + (float)((1 << (width - 1)) - 1);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, tig = lane & 3;
  const int ct = warp & 1;       // this warp's 16-column tile of the block
  const int q = warp >> 1;       // and its word-row groups q and q + 4 of every tile
  const int n_lo = ct * 16 + g;  // this lane's columns n_lo and n_lo + 8
  const int col0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * kRows;
  const int rows = min(kRows, M - m0);
  const int n_tiles = k_pad / tile;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(ring + s * slot_bytes, words, scales, s, nsb, col0, N);
    cp_async_commit();
  }
  const bool vec = Kx % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  float xv[P][4];
  load_x<P>(xv, x, 0, m0, rows, Kx, vec);

  for (int t = 0; t < n_tiles; ++t) {
    uint32_t* xb = xs + (t & 1) * tile * kRows / 2;
    store_x<P>(xb, xv);
    if (t + 1 < n_tiles) load_x<P>(xv, x, (t + 1) * tile, m0, rows, Kx, vec);
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < n_tiles)
      load_tile(ring + ((t + kStages - 1) % kStages) * slot_bytes, words, scales,
                t + kStages - 1, nsb, col0, N);
    cp_async_commit();

    const uint8_t* slot = ring + (t % kStages) * slot_bytes;
    const uint32_t* wt = reinterpret_cast<const uint32_t*>(slot);
    const uint8_t* es = slot + 4 * kTileWords;
    const uint2* xf = reinterpret_cast<const uint2*>(xb);
#pragma unroll
    for (int gi = 0; gi < 2; ++gi) {
      const int r0 = (q + 4 * gi) * 16 + 2 * tig;  // word rows r0, r0+1, r0+8, r0+9
      uint32_t w[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + (i & 1) + 8 * (i >> 1);
        w[i][0] = wt[word_slot(row, n_lo)];
        w[i][1] = wt[word_slot(row, n_lo + 8)];
      }
      const int n_shifts = V == kStream ? 1 : per_word;
      for (int j = 0; j < n_shifts; ++j) {
        const int sh = width * j;
        const int kr = j * kSlice + r0;  // K row in the tile of word row r0
        float wv[4][2];
        if constexpr (V == kStream) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c) wv[i][c] = (float)(int)w[i][c];
        } else {
          // scale term of (word row r0 + dr, column n_lo + 8 c); extract and
          // mulconst use none
          float s[4][2] = {};
          if constexpr (V == kShip || V == kMuladd || V == kShift2) {
            if (bs >= 16) {  // the 16 rows of the k-step share one scale block
              const uint8_t* e = es + (kr / bs) * kCols + n_lo;
              const float s0 = scale_term<V>(e[0]), s1 = scale_term<V>(e[8]);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                s[i][0] = s0;
                s[i][1] = s1;
              }
            } else {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const uint8_t* e = es + ((kr + (i & 1) + 8 * (i >> 1)) / bs) * kCols + n_lo;
                s[i][0] = scale_term<V>(e[0]);
                s[i][1] = scale_term<V>(e[8]);
              }
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float cf = __uint_as_float(((w[i][c] >> sh) & mask) | 0x4B000000u) - magic;
              wv[i][c] = probe_weight<V, false>(cf, w[i][c], sh, width, s[i][c]);
            }
        }
        // A fragment: rows n_lo / n_lo + 8, k = 2 tig (+1) and 2 tig + 8 (+9)
        const uint32_t a[4] = {pack_bf16x2(wv[0][0], wv[1][0]), pack_bf16x2(wv[0][1], wv[1][1]),
                               pack_bf16x2(wv[2][0], wv[3][0]), pack_bf16x2(wv[2][1], wv[3][1])};
        const int step = kr >> 4;
        mma_bf16(acc, a, xf[step * 32 + (lane ^ ((step & 7) << 2))]);
      }
    }
  }

  // combine the 4 word-row warps of each column tile, q = 0 first
  float* red = reinterpret_cast<float*>(xs);  // [4 q][2 ct][32 lanes][4]
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) red[((q * 2 + ct) * 32 + lane) * 4 + i] = acc[i];
  __syncthreads();
  for (int o = threadIdx.x; o < kRows * kCols; o += kThreads) {
    const int m = o / kCols, n = o % kCols;
    if (m >= rows || col0 + n >= N) continue;
    const int c = n >> 4, src_lane = (n & 7) * 4 + (m >> 1);
    const int reg = (m & 1) + 2 * ((n & 15) >> 3);
    float sum = 0.f;
    for (int w = 0; w < 4; ++w) sum += red[((w * 2 + c) * 32 + src_lane) * 4 + reg];
    y[(size_t)(m0 + m) * N + col0 + n] = sum;
  }
}

// ------------------------------------------------- lane-major (K3's design)

template <int V>
__global__ void __launch_bounds__(kThreads)
probe_lm_kernel(const float* __restrict__ x, const uint32_t* __restrict__ words,
                const uint8_t* __restrict__ scales, float* __restrict__ y,
                int M, int N, int Kx, int k_pad, int width, int bs) {
  extern __shared__ __align__(16) float smem_lm[];
  const int per_word = 32 / width;
  const int tile = per_word * kSlice;
  const int nsb = tile / bs;             // scale bytes per column and tile
  const int n_words = k_pad / per_word;  // words per column
  float* xs = smem_lm;                   // [tile][kRows]: bf16(x) of the current tile
  float* ss = xs + tile * kRows;         // [kCols][nsb]: its decoded scale terms
  const uint32_t mask = (1u << width) - 1u;
  const int cmax = (1 << (width - 1)) - 1;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col0 = blockIdx.x * kCols;
  const int c0 = warp * kColsPerWarp;  // this warp's first column in the block
  const int ncols = min(kCols, N - col0);
  const int m0 = blockIdx.y * kRows;
  const int rows = min(kRows, M - m0);
  const int n_tiles = k_pad / tile;

  float acc[kColsPerWarp][kRows];
#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c)
#pragma unroll
    for (int m = 0; m < kRows; ++m) acc[c][m] = 0.f;
  // scale slot of K row j*128 + 32g + lane: j * slice_sb + lane_sb[g]
  const int slice_sb = kSlice / bs;
  int lane_sb[kLaneWords];
#pragma unroll
  for (int g = 0; g < kLaneWords; ++g) lane_sb[g] = (32 * g + lane) / bs;

  // nxt[c][g]: word row 32g + lane of the next tile, column c0 + c
  uint32_t nxt[kColsPerWarp][kLaneWords];
#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c)
#pragma unroll
    for (int g = 0; g < kLaneWords; ++g)
      nxt[c][g] = c0 + c < ncols
                      ? __ldg(words + (size_t)(col0 + c0 + c) * n_words + 32 * g + lane) : 0u;

  for (int t = 0; t < n_tiles; ++t) {
    uint32_t cur[kColsPerWarp][kLaneWords];
#pragma unroll
    for (int c = 0; c < kColsPerWarp; ++c)
#pragma unroll
      for (int g = 0; g < kLaneWords; ++g) cur[c][g] = nxt[c][g];
    if (t + 1 < n_tiles) {
#pragma unroll
      for (int c = 0; c < kColsPerWarp; ++c)
#pragma unroll
        for (int g = 0; g < kLaneWords; ++g)
          nxt[c][g] = c0 + c < ncols
                          ? __ldg(words + (size_t)(col0 + c0 + c) * n_words +
                                  (t + 1) * kSlice + 32 * g + lane) : 0u;
    }
    __syncthreads();  // the previous tile's xs / ss are no longer read
    // scale bytes: the block's columns of tile t are ncols * nsb consecutive
    // bytes; up to 8 loads in flight per thread
    const uint8_t* st = scales + ((size_t)t * N + col0) * nsb;
    for (int i0 = threadIdx.x; i0 < ncols * nsb; i0 += 8 * kThreads) {
      uint8_t e8[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * kThreads;
        e8[u] = i < ncols * nsb ? __ldg(st + i) : 0;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * kThreads;
        if (i < ncols * nsb) ss[i] = scale_term<V>(e8[u]);
      }
    }
    // x: a thread loads one K position of every row at once
    for (int kk = threadIdx.x; kk < tile; kk += kThreads) {
      const int k = t * tile + kk;
      float v[kRows];
#pragma unroll
      for (int m = 0; m < kRows; ++m)
        v[m] = (m < rows && k < Kx) ? bf16_round_bits(__ldg(x + (size_t)(m0 + m) * Kx + k)) : 0.f;
#pragma unroll
      for (int m = 0; m < kRows; m += 4)
        *reinterpret_cast<float4*>(xs + kk * kRows + m) = make_float4(v[m], v[m + 1], v[m + 2], v[m + 3]);
    }
    __syncthreads();
    if (c0 >= ncols) continue;  // a warp past N still joins the barriers
    const int n_shifts = V == kStream ? 1 : per_word;
    for (int j = 0; j < n_shifts; ++j) {
      const int sh = width * j;
#pragma unroll
      for (int g = 0; g < kLaneWords; ++g) {
        const int kk = j * kSlice + 32 * g + lane;  // K row in the tile
        const int sb = j * slice_sb + lane_sb[g];
        float wv[kColsPerWarp];
#pragma unroll
        for (int c = 0; c < kColsPerWarp; ++c) {
          if constexpr (V == kStream) {
            wv[c] = bf16_round((float)(int)cur[c][g]);
          } else {
            // columns past N read a scale slot no one wrote; their sums are
            // never stored
            const int code = (int)((cur[c][g] >> sh) & mask) - cmax;
            wv[c] = probe_weight<V, true>((float)code, cur[c][g], sh, width,
                                          ss[(c0 + c) * nsb + sb]);
          }
        }
#pragma unroll
        for (int m = 0; m < kRows; m += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(xs + kk * kRows + m);
#pragma unroll
          for (int c = 0; c < kColsPerWarp; ++c) {
            acc[c][m] = fmaf(xv.x, wv[c], acc[c][m]);
            acc[c][m + 1] = fmaf(xv.y, wv[c], acc[c][m + 1]);
            acc[c][m + 2] = fmaf(xv.z, wv[c], acc[c][m + 2]);
            acc[c][m + 3] = fmaf(xv.w, wv[c], acc[c][m + 3]);
          }
        }
      }
    }
  }

  // sum each (column, row) over the warp's lanes; lane 0 holds the result
#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c)
#pragma unroll
    for (int m = 0; m < kRows; ++m)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[c][m] += __shfl_down_sync(0xffffffffu, acc[c][m], o);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kColsPerWarp; ++c)
#pragma unroll
      for (int m = 0; m < kRows; ++m)
        if (m < rows && c0 + c < ncols) y[(size_t)(m0 + m) * N + col0 + c0 + c] = acc[c][m];
  }
}

// ------------------------------------------------------------- launch

template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct Args {
  const void *x, *words, *scales;
  void* y;
  int M, N, Kx, k_pad, width, bs;
  cudaStream_t stream;
};

template <typename Kernel>
int launch(Kernel kernel, int smem, const Args& a) {
  const int tile = (32 / a.width) * kSlice;
  if (smem > kSmemMax || a.k_pad % tile) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.N + kCols - 1) / kCols, (a.M + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      (const float*)a.x, (const uint32_t*)a.words, (const uint8_t*)a.scales, (float*)a.y,
      a.M, a.N, a.Kx, a.k_pad, a.width, a.bs);
  return (int)cudaGetLastError();
}

template <int V>
int launch_variant(int layout, const Args& a) {
  const int per_word = 32 / a.width;
  const int tile = per_word * kSlice;
  if (layout == kLaneMajor)
    return launch(probe_lm_kernel<V>, 4 * (tile * kRows + (tile / a.bs) * kCols), a);
  const int smem = kStages * slot_bytes_of(tile / a.bs) + 4 * tile * kRows;
  switch (per_word) {
    case 4: return launch(probe_t_kernel<V, 4>, smem, a);
    case 5: return launch(probe_t_kernel<V, 5>, smem, a);
    case 6: return launch(probe_t_kernel<V, 6>, smem, a);
    case 8: return launch(probe_t_kernel<V, 8>, smem, a);
    case 10: return launch(probe_t_kernel<V, 10>, smem, a);
    case 16: return launch(probe_t_kernel<V, 16>, smem, a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* lmq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// layout: 0 transposed (P8), 1 lane-major (P9); variant: 0 ship, 1 stream,
// 2 extract, 3 mulconst, 4 muladd, 5 shift2. x is [M, Kx], read as 0 past
// Kx (Kx <= k_pad).
int lmq_probe_subbyte(const void* x, const void* words, const void* scales, void* y, int M,
                      int N, int Kx, int k_pad, int width, int bs, int layout, int variant,
                      void* stream) {
  if (width < 2 || width > 8 || bs < 1 || kSlice % bs || Kx > k_pad || M < 1 || N < 1 ||
      (layout != kTransposed && layout != kLaneMajor))
    return (int)cudaErrorInvalidValue;
  const Args a{x, words, scales, y, M, N, Kx, k_pad, width, bs,
               static_cast<cudaStream_t>(stream)};
  switch (variant) {
    case kShip: return launch_variant<kShip>(layout, a);
    case kStream: return launch_variant<kStream>(layout, a);
    case kExtract: return launch_variant<kExtract>(layout, a);
    case kMulconst: return launch_variant<kMulconst>(layout, a);
    case kMuladd: return launch_variant<kMuladd>(layout, a);
    case kShift2: return launch_variant<kShift2>(layout, a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
