// The sub-byte probe kernels' shared body: copies of K1 (the transposed
// layout, mma.sync on the tensor cores) and of K3's former design (the
// lane-major layout, float32 FMAs on the CUDA cores; subbyte_tile's c32_t1
// is the same design), templated on a variant V that picks what
// happens between a stored word and the product, and the type of the stored
// block scale. subbyte_probe.cu instantiates the stage knock-outs (P8, P9),
// variant_probe.cu the dequant-arithmetic and scale-storage variants (P1,
// P3); each source states its variants' semantics and what bounds them.
// int8_probe.cu (P2) uses the constants and helpers only.
//
// Both copies take 8 rows of x a block, rounded to bf16 and never
// quantized; x is [M, Kx], read as 0 past Kx (Kx <= k_pad).
// - Transposed (PackedBFPSubT: uint32 words [K_pad / per_word, N], block
//   scales [K_pad / bs, N]): N on the mma's 16 rows, a 3-tile cp.async ring
//   for words and scales, the next tile's x in registers, 256 threads, 2
//   blocks an SM.
// - Lane-major (PackedBFPSub: words [N, K_pad / per_word], block scales
//   [n_tiles, N, tile / bs]): lanes along K, 4 columns a warp, the next
//   tile's words in registers, the tile's scales decoded into shared memory.
#pragma once

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

enum Variant {
  // stage knock-outs (P8, P9): subbyte_probe.cu
  kShip = 0, kStream, kExtract, kMulconst, kMuladd, kShift2,
  // dequant arithmetic on the scale bytes (P1), scales stored decoded (P3):
  // variant_probe.cu
  kV2, kV3, kV4F32, kV4Bf16,
};
enum Layout { kTransposed = 0, kLaneMajor = 1 };

// The stored type of a block scale under variant V: the uint8 exponent
// byte, or (P3) the decoded scale as float32 or as the bits of a bf16.
template <int V> struct ScaleOf { using type = uint8_t; };
template <> struct ScaleOf<kV4F32> { using type = float; };
template <> struct ScaleOf<kV4Bf16> { using type = uint16_t; };

// the knock-outs that read the scale
__host__ __device__ constexpr bool uses_scale(int v) {
  return v == kShip || v == kMuladd || v == kShift2;
}

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

// What a stored scale contributes under variant V: the scale, or for muladd
// the bits to add into a float's exponent.
template <int V>
__device__ __forceinline__ float scale_term(typename ScaleOf<V>::type raw) {
  if constexpr (V == kMuladd) {
    return __uint_as_float((uint32_t)((int)raw - 128) << 23);
  } else if constexpr (V == kV4F32) {
    return raw;
  } else if constexpr (V == kV4Bf16) {
    return __uint_as_float((uint32_t)raw << 16);
  } else {
    return probe_scale(raw);
  }
}

// The weight of one stored field under a knock-out V (not stream), given
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

// bf16(a) * bf16(b) of two pairs in one bf16x2 multiply (v2, v3): a are
// integer codes, b scales; every value is exact in bf16
__device__ __forceinline__ __nv_bfloat162 mul_bf16x2(int a_lo, int a_hi, float b_lo, float b_hi) {
  return __hmul2(__halves2bfloat162(__int2bfloat16_rn(a_lo), __int2bfloat16_rn(a_hi)),
                 __floats2bfloat162_rn(b_lo, b_hi));
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

__device__ __forceinline__ uint32_t bits_bf16x2(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ int word_slot(int row, int col) {
  return row * kCols + (col ^ (((row >> 1) & 3) << 3));
}

// a ring slot: the tile's words, then its nsb rows of kCols scales of sb
// bytes each
__host__ __device__ __forceinline__ int slot_bytes_of(int nsb, int sb) {
  return 4 * kTileWords + (nsb * kCols * sb + 15) / 16 * 16;
}

// K1's k1_load_tile: tile t's words and scales of the block's columns into
// ring slot `dst`, zero past N. The scales move as bytes: SB bytes a scale,
// rows of N * SB bytes.
template <int SB>
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
  constexpr int kRowBytes = kCols * SB;  // a slot row: the block's columns
  const int nb = N * SB, cb0 = col0 * SB;
  uint8_t* ds = dst + 4 * kTileWords;  // [nsb][kCols] scales
  const uint8_t* ssrc = scales + (size_t)t * nsb * nb + cb0;
  if (nb % 16 == 0) {
    for (int i = threadIdx.x; i < nsb * (kRowBytes / 16); i += kThreads) {
      const int row = i / (kRowBytes / 16), col = 16 * (i % (kRowBytes / 16));
      const bool in = cb0 + col < nb;
      cp_async16(ds + row * kRowBytes + col, in ? ssrc + (size_t)row * nb + col : scales,
                 in ? 16 : 0);
    }
  } else if (nb % 4 == 0) {
    for (int i = threadIdx.x; i < nsb * (kRowBytes / 4); i += kThreads) {
      const int row = i / (kRowBytes / 4), col = 4 * (i % (kRowBytes / 4));
      const bool in = cb0 + col < nb;
      cp_async4(ds + row * kRowBytes + col, in ? ssrc + (size_t)row * nb + col : scales,
                in ? 4 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < nsb * kRowBytes; i += kThreads) {
      const int row = i / kRowBytes, col = i % kRowBytes;
      ds[i] = cb0 + col < nb ? __ldg(ssrc + (size_t)row * nb + col) : 0;
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
// fragments [tile / 16 k-steps][32 lanes][4 bf16], lanes XOR-permuted. With
// kSums (v3), also the sums of bf16(x) over each run of seg (4, 8 or 16) K
// rows of a row, xsum [tile / seg][kRows]: a lane's 4 values, then a
// butterfly over the seg / 4 lanes of the run.
template <int P, bool kSums = false>
__device__ __forceinline__ void store_x(uint32_t* xb, const float (&v)[P][4],
                                        float* xsum = nullptr, int seg = 16) {
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
    if constexpr (kSums) {
      float s = (bf16_round(v[i][0]) + bf16_round(v[i][1])) +
                (bf16_round(v[i][2]) + bf16_round(v[i][3]));
      for (int o = 1; o < seg / 4; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if ((lane & (seg / 4 - 1)) == 0)
        xsum[((kSlice * (wu / kRows) + 4 * lane) / seg) * kRows + m] = s;
    }
  }
}

// P = per_word: units of 4 x values a thread stages per tile; kU (the
// variants of P1/P3 at blocks of 16 or more): the 16 rows of a k-step share
// one scale block
template <int V, int P, bool kU = false>
__global__ void __launch_bounds__(kThreads, 2)
probe_t_kernel(const float* __restrict__ x, const uint32_t* __restrict__ words,
               const void* __restrict__ scales_v, float* __restrict__ y,
               int M, int N, int Kx, int k_pad, int width, int bs) {
  using S = typename ScaleOf<V>::type;
  const uint8_t* scales = static_cast<const uint8_t*>(scales_v);
  extern __shared__ __align__(16) uint8_t smem_t[];
  const int per_word = 32 / width;
  const int tile = per_word * kSlice;
  const int nsb = tile / bs;
  const int slot_bytes = slot_bytes_of(nsb, sizeof(S));
  uint8_t* ring = smem_t;                                                 // [kStages] slots
  uint32_t* xs = reinterpret_cast<uint32_t*>(ring + kStages * slot_bytes);  // [2][tile * kRows / 2]
  // v3: x's sums over runs of seg K rows (a block, or the 16 rows of it a
  // k-step holds), [2][tile / seg][kRows]
  const int seg = min(bs, 16);
  float* xsums = reinterpret_cast<float*>(xs + tile * kRows);
  const uint32_t mask = (1u << width) - 1u;
  const int cmax = (1 << (width - 1)) - 1;
  // code - cmax = float(0x4B000000 | code) - (2^23 + cmax), exactly
  const float magic = 8388608.f + (float)cmax;

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
  float corr[4] = {0.f, 0.f, 0.f, 0.f};  // v3: sum of s * sum(x) over the k-steps
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile<sizeof(S)>(ring + s * slot_bytes, words, scales, s, nsb, col0, N);
    cp_async_commit();
  }
  const bool vec = Kx % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  float xv[P][4];
  load_x<P>(xv, x, 0, m0, rows, Kx, vec);

  for (int t = 0; t < n_tiles; ++t) {
    uint32_t* xb = xs + (t & 1) * tile * kRows / 2;
    float* xsum = xsums + (t & 1) * (tile / seg) * kRows;
    store_x<P, V == kV3>(xb, xv, xsum, seg);
    if (t + 1 < n_tiles) load_x<P>(xv, x, (t + 1) * tile, m0, rows, Kx, vec);
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < n_tiles)
      load_tile<sizeof(S)>(ring + ((t + kStages - 1) % kStages) * slot_bytes, words, scales,
                           t + kStages - 1, nsb, col0, N);
    cp_async_commit();

    const uint8_t* slot = ring + (t % kStages) * slot_bytes;
    const uint32_t* wt = reinterpret_cast<const uint32_t*>(slot);
    const S* es = reinterpret_cast<const S*>(slot + 4 * kTileWords);
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
        // A fragment: rows n_lo / n_lo + 8, k = 2 tig (+1) and 2 tig + 8 (+9);
        // register p holds word rows i, i + 1 (i = 2 (p >> 1)) of column c = p & 1
        uint32_t a[4];
        if constexpr (V >= kV2) {
          // scale of word rows r0 + 8 h and + 1 (blocks of 4 or more pair
          // them), column n_lo + 8 c
          float s[2][2];
#pragma unroll
          for (int h = 0; h < (kU ? 1 : 2); ++h) {
            const S* e = es + ((kr + 8 * h) / bs) * kCols + n_lo;
            s[h][0] = scale_term<V>(e[0]);
            s[h][1] = scale_term<V>(e[8]);
          }
          if constexpr (kU) {
            s[1][0] = s[0][0];
            s[1][1] = s[0][1];
          }
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const int i = (p >> 1) * 2, h = p >> 1, c = p & 1;
            const uint32_t lo = (w[i][c] >> sh) & mask, hi = (w[i + 1][c] >> sh) & mask;
            if constexpr (V == kV2 || V == kV3) {
              const int off = V == kV2 ? cmax : 0;  // v3 keeps the biased code
              a[p] = bits_bf16x2(mul_bf16x2((int)lo - off, (int)hi - off, s[h][c], s[h][c]));
            } else {  // v4: fma(c_b, s, -cmax s) on the stored (biased) field c_b
              const float ns = -(float)cmax * s[h][c];
              a[p] = pack_bf16x2(fmaf(__uint_as_float(lo | 0x4B000000u) - 8388608.f, s[h][c], ns),
                                 fmaf(__uint_as_float(hi | 0x4B000000u) - 8388608.f, s[h][c], ns));
            }
          }
          if constexpr (V == kV3) {
            // the k-step's share of the correction: for each run of seg rows,
            // its scale (columns n_lo, n_lo + 8) times the sum of x (rows
            // 2 tig, 2 tig + 1); with kU one run, the k-step's own scales
            const int kb = kr & ~15;
            for (int k0 = kb; k0 < kb + 16; k0 += seg) {
              float s0 = s[0][0], s1 = s[0][1];
              if constexpr (!kU) {
                const S* e = es + (k0 / bs) * kCols + n_lo;
                s0 = scale_term<V>(e[0]);
                s1 = scale_term<V>(e[8]);
              }
              const float2 xsm = *reinterpret_cast<const float2*>(xsum + (k0 / seg) * kRows + 2 * tig);
              corr[0] = fmaf(xsm.x, s0, corr[0]);
              corr[1] = fmaf(xsm.y, s0, corr[1]);
              corr[2] = fmaf(xsm.x, s1, corr[2]);
              corr[3] = fmaf(xsm.y, s1, corr[3]);
            }
          }
        } else {
          // scale term of (word row r0 + dr, column n_lo + 8 c); stream,
          // extract and mulconst use none
          float s[4][2] = {};
          if constexpr (uses_scale(V)) {
            if (bs >= 16) {  // the 16 rows of the k-step share one scale block
              const S* e = es + (kr / bs) * kCols + n_lo;
              const float s0 = scale_term<V>(e[0]), s1 = scale_term<V>(e[8]);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                s[i][0] = s0;
                s[i][1] = s1;
              }
            } else {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const S* e = es + ((kr + (i & 1) + 8 * (i >> 1)) / bs) * kCols + n_lo;
                s[i][0] = scale_term<V>(e[0]);
                s[i][1] = scale_term<V>(e[8]);
              }
            }
          }
          float wv[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              if constexpr (V == kStream) {
                wv[i][c] = (float)(int)w[i][c];
              } else {
                const float cf = __uint_as_float(((w[i][c] >> sh) & mask) | 0x4B000000u) - magic;
                wv[i][c] = probe_weight<V, false>(cf, w[i][c], sh, width, s[i][c]);
              }
            }
          a[0] = pack_bf16x2(wv[0][0], wv[1][0]);
          a[1] = pack_bf16x2(wv[0][1], wv[1][1]);
          a[2] = pack_bf16x2(wv[2][0], wv[3][0]);
          a[3] = pack_bf16x2(wv[2][1], wv[3][1]);
        }
        const int step = kr >> 4;
        mma_bf16(acc, a, xf[step * 32 + (lane ^ ((step & 7) << 2))]);
      }
    }
  }
  if constexpr (V == kV3) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = fmaf(-(float)cmax, corr[i], acc[i]);
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

// ------------------------------------------ lane-major (K3's former design)

// v3's x sums on the lane-major layout: the lanes of a warp hold 32
// consecutive K rows, each v[0..8) of the 8 rows of x; writes the sums over
// each run of seg (4..32) lanes to run[row] (run: this lane's run's 8
// sums). A reduce-scatter halves the values a lane holds at each of the
// first steps (the lane with the step's bit set keeps the upper half), a
// butterfly adds the rest: 8 shuffles at seg = 16 instead of 32.
__device__ __forceinline__ void run_sums(float (&v)[kRows], int seg, int lane, float* run) {
  const bool b1 = lane & 1, b2 = lane & 2, b4 = lane & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // lanes 2a, 2a + 1: rows 0-3 / 4-7
    const float send = b1 ? v[i] : v[i + 4];
    v[i] = (b1 ? v[i + 4] : v[i]) + __shfl_xor_sync(0xffffffffu, send, 1);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // then rows +0-1 / +2-3 of those
    const float send = b2 ? v[i] : v[i + 2];
    v[i] = (b2 ? v[i + 2] : v[i]) + __shfl_xor_sync(0xffffffffu, send, 2);
  }
  const int row = 4 * b1 + 2 * b2;  // this lane's rows row, row + 1
  if (seg == 4) {  // lanes 4a .. 4a + 3: every lane two rows of its run
    run[row] = v[0];
    run[row + 1] = v[1];
    return;
  }
  const float send = b4 ? v[0] : v[1];
  float sum = (b4 ? v[1] : v[0]) + __shfl_xor_sync(0xffffffffu, send, 4);  // row + b4
  for (int o = 8; o < seg; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if ((lane & (seg - 1) & ~7) == 0) run[row + b4] = sum;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
probe_lm_kernel(const float* __restrict__ x, const uint32_t* __restrict__ words,
                const void* __restrict__ scales_v, float* __restrict__ y,
                int M, int N, int Kx, int k_pad, int width, int bs) {
  using S = typename ScaleOf<V>::type;
  const S* scales = static_cast<const S*>(scales_v);
  extern __shared__ __align__(16) float smem_lm[];
  const int per_word = 32 / width;
  const int tile = per_word * kSlice;
  const int nsb = tile / bs;             // scales per column and tile
  const int n_words = k_pad / per_word;  // words per column
  float* xs = smem_lm;                   // [tile][kRows]: bf16(x) of the current tile
  float* ss = xs + tile * kRows;         // [kCols][nsb]: its decoded scale terms
  // v3: x's sums over runs of seg K rows (a block, or 32 rows of it),
  // [tile / seg][kRows]
  const int seg = min(bs, 32);
  float* xsum = ss + nsb * kCols;
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
    // scales: the block's columns of tile t are ncols * nsb consecutive
    // elements; up to 8 loads in flight per thread
    const S* st = scales + ((size_t)t * N + col0) * nsb;
    for (int i0 = threadIdx.x; i0 < ncols * nsb; i0 += 8 * kThreads) {
      S raw[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * kThreads;
        raw[u] = i < ncols * nsb ? __ldg(st + i) : S(0);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * kThreads;
        if (i < ncols * nsb) ss[i] = scale_term<V>(raw[u]);
      }
    }
    // x: a thread loads one K position of every row at once (the lanes of a
    // warp hold 32 consecutive K; v3 sums runs of seg of them by butterfly)
    for (int kk = threadIdx.x; kk < tile; kk += kThreads) {
      const int k = t * tile + kk;
      float v[kRows];
#pragma unroll
      for (int m = 0; m < kRows; ++m)
        v[m] = (m < rows && k < Kx) ? bf16_round_bits(__ldg(x + (size_t)(m0 + m) * Kx + k)) : 0.f;
#pragma unroll
      for (int m = 0; m < kRows; m += 4)
        *reinterpret_cast<float4*>(xs + kk * kRows + m) = make_float4(v[m], v[m + 1], v[m + 2], v[m + 3]);
      if constexpr (V == kV3) run_sums(v, seg, lane, xsum + (kk / seg) * kRows);
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
        // columns past N read a scale slot no one wrote; their sums are
        // never stored
        float wv[kColsPerWarp];
        if constexpr (V == kV2) {
          // bf16(code - cmax) * bf16(s) for two columns in one bf16x2 multiply
#pragma unroll
          for (int c = 0; c < kColsPerWarp; c += 2) {
            const __nv_bfloat162 p = mul_bf16x2(
                (int)((cur[c][g] >> sh) & mask) - cmax, (int)((cur[c + 1][g] >> sh) & mask) - cmax,
                ss[(c0 + c) * nsb + sb], ss[(c0 + c + 1) * nsb + sb]);
            wv[c] = __low2float(p);
            wv[c + 1] = __high2float(p);
          }
        } else {
#pragma unroll
          for (int c = 0; c < kColsPerWarp; ++c) {
            const int field = (int)((cur[c][g] >> sh) & mask);
            if constexpr (V == kStream) {
              wv[c] = bf16_round((float)(int)cur[c][g]);
            } else if constexpr (V == kV3) {
              wv[c] = (float)field * ss[(c0 + c) * nsb + sb];  // the biased code
            } else if constexpr (V == kV4F32 || V == kV4Bf16) {
              const float s = ss[(c0 + c) * nsb + sb];
              wv[c] = fmaf((float)field, s, -(float)cmax * s);
            } else {
              wv[c] = probe_weight<V, true>((float)(field - cmax), cur[c][g], sh, width,
                                            ss[(c0 + c) * nsb + sb]);
            }
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
    if constexpr (V == kV3) {
      // the tile's correction, -cmax * s * sum(x) for each run of seg rows,
      // the runs spread over the lanes
      for (int r = lane; r < tile / seg; r += 32) {
        const float4 xa = *reinterpret_cast<const float4*>(xsum + r * kRows);
        const float4 xc = *reinterpret_cast<const float4*>(xsum + r * kRows + 4);
        const float xr[kRows] = {xa.x, xa.y, xa.z, xa.w, xc.x, xc.y, xc.z, xc.w};
#pragma unroll
        for (int c = 0; c < kColsPerWarp; ++c) {
          const float ns = -(float)cmax * ss[(c0 + c) * nsb + r * seg / bs];
#pragma unroll
          for (int m = 0; m < kRows; ++m) acc[c][m] = fmaf(xr[m], ns, acc[c][m]);
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
      (const float*)a.x, (const uint32_t*)a.words, a.scales, (float*)a.y,
      a.M, a.N, a.Kx, a.k_pad, a.width, a.bs);
  return (int)cudaGetLastError();
}

template <int V, int P>
int launch_t(int smem, const Args& a) {
  if constexpr (V >= kV2) {
    if (a.bs >= 16) return launch(probe_t_kernel<V, P, true>, smem, a);
  }
  return launch(probe_t_kernel<V, P>, smem, a);
}

template <int V>
int launch_variant(int layout, const Args& a) {
  const int per_word = 32 / a.width;
  const int tile = per_word * kSlice;
  const int nsb = tile / a.bs;
  if (layout == kLaneMajor) {
    const int sums = V == kV3 ? 4 * (tile / min(a.bs, 32)) * kRows : 0;
    return launch(probe_lm_kernel<V>, 4 * (tile * kRows + nsb * kCols) + sums, a);
  }
  const int sums = V == kV3 ? 2 * 4 * (tile / min(a.bs, 16)) * kRows : 0;
  const int smem = kStages * slot_bytes_of(nsb, sizeof(typename ScaleOf<V>::type)) +
                   4 * tile * kRows + sums;
  switch (per_word) {
    case 4: return launch_t<V, 4>(smem, a);
    case 5: return launch_t<V, 5>(smem, a);
    case 6: return launch_t<V, 6>(smem, a);
    case 8: return launch_t<V, 8>(smem, a);
    case 10: return launch_t<V, 10>(smem, a);
    case 16: return launch_t<V, 16>(smem, a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
