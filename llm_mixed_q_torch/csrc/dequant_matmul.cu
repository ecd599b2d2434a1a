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
// All three fold the block_fp activation quantizer (_qdq_lanes_signed on the
// TPU) into their prologue: each block quantizes its K-step of x on the way
// into shared memory, a quantizer block being a run of 1..32 lanes of a warp.
//
// What bounds them on an H100: at decode M (<= 16 rows) the product does
// 2*M flops per weight element and reads the packed weight once, so its
// bytes (the packed weight, plus 4*M*(K+N) for x and y) over the 3.35 TB/s
// memory rate bound it (Llama-2-7B: ~6.9 bits per element sub-byte, 10 bits
// int8; K1 and K3 read the same bytes, in two layouts);
// at M = 8 the float32 FMAs on the CUDA cores (67 TFLOP/s) cost about as
// much. Design: a block owns 32 output columns and up to 16 rows, and its
// 8 warps share the work of those columns, so a 4096-wide projection
// already spreads over 128 blocks (the whole card) with 8 warps on each SM
// to hide latency:
// - K1: lane = column (the words' N axis is the fastest, so a warp's loads
//   are coalesced); warp w takes word rows 16w..16w+15 of every packing
//   tile and keeps the next tile's 16 words in flight in registers while it
//   decodes the current ones. x is staged [k][row], so one 16-byte shared
//   load feeds four rows.
// - K2: lanes run along K (codes are [N, K]: 4 codes per lane, 128 per warp
//   load, coalesced); warp w takes 4 columns and reuses each x load for
//   all 4. A chunk's codes are loaded before its x is staged, so the loads
//   overlap the staging.
// - K3: lanes run along K as in K2 (a column's words are contiguous: lane
//   r holds word rows r, r+32, r+64, r+96 of a tile, 128 bytes a warp
//   load); warp w takes 4 columns and keeps the next tile's 16 words in
//   flight in registers, as K1 does. Slice j of a word is K row
//   j*128 + 32g + lane of the tile, so x is staged [k][row] as in K1 and
//   one 16-byte shared load feeds four rows of all 4 columns. The tile's
//   scales of the block's 32 columns are one contiguous run of bytes
//   (scales[t, col0:col0+32, :]); the block decodes them into shared
//   memory once a tile instead of every thread reading bytes.
// Staging loads a K position of every row at once (ROWS loads in flight a
// thread) and quantizes on the way: the quantizer's block max is a shuffle
// reduction over a run of lanes, and divisions by powers of two are exact
// multiplications. Each row is summed in a fixed order (per warp, then the
// warps or lanes combined in a fixed order): a row's result does not depend
// on M or on the other rows (no split across blocks, no atomics).
// Accumulation is float32 on the CUDA cores; the tensor cores stay idle.

#include <cstdint>
#include <cuda_runtime.h>

#include "bfp_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 32;                      // output columns per block
constexpr int kSlice = 128;                    // K1, K3: words per column and packing tile
constexpr int kRowsPerWarp = kSlice / kWarps;  // K1: word rows per warp and tile
constexpr int kColsPerWarp = kCols / kWarps;   // K2, K3: columns per warp
constexpr int kLaneWords = kSlice / 32;        // K3: words per lane, column and tile
constexpr int kChunk = 512;                    // K2: K per step, 4 codes per lane x 4
constexpr int kSmemMax = 227 * 1024;

__device__ __forceinline__ float scale_from_e8(uint8_t e8) {
  return lmq::exact_exp2i((int)e8 - 128);
}

// acc[m] += xk[m] * wv for every row; xk is 16-byte aligned, ROWS % 4 == 0
template <int ROWS>
__device__ __forceinline__ void fma_rows(float (&acc)[ROWS], const float* xk, float wv) {
#pragma unroll
  for (int m = 0; m < ROWS; m += 4) {
    const float4 xv = *reinterpret_cast<const float4*>(xk + m);
    acc[m] = fmaf(xv.x, wv, acc[m]);
    acc[m + 1] = fmaf(xv.y, wv, acc[m + 1]);
    acc[m + 2] = fmaf(xv.z, wv, acc[m + 2]);
    acc[m + 3] = fmaf(xv.w, wv, acc[m + 3]);
  }
}

// Stage x rows m0 .. m0 + ROWS - 1 at K positions k0 .. k0 + len - 1 into
// xs [len][ROWS], zero past K and past the live rows, quantized on the way.
// A thread loads one K position of every row at once; the lanes of a warp
// hold consecutive K, so the activation quantizer's blocks are runs of
// lanes. len % 32 == 0, so whole warps take part in the shuffles.
template <int ROWS>
__device__ __forceinline__ void stage_x_rows(float* xs, const float* __restrict__ x, int k0,
                                             int len, int m0, int rows, int K,
                                             const lmq::BfpSpec& aq) {
  for (int kk = threadIdx.x; kk < len; kk += kThreads) {
    const int k = k0 + kk;
    float v[ROWS];
#pragma unroll
    for (int m = 0; m < ROWS; ++m)
      v[m] = (m < rows && k < K) ? __ldg(x + (size_t)(m0 + m) * K + k) : 0.f;
    if (aq.on) {
#pragma unroll
      for (int m = 0; m < ROWS; ++m) v[m] = lmq::bfp_qdq_lanes(v[m], aq);
    }
#pragma unroll
    for (int m = 0; m < ROWS; m += 4)
      *reinterpret_cast<float4*>(xs + kk * ROWS + m) = make_float4(v[m], v[m + 1], v[m + 2], v[m + 3]);
  }
}

// ---------------------------------------------------------------- K1

template <int ROWS>
__global__ void __launch_bounds__(kThreads)
subbyte_t_kernel(const float* __restrict__ x, const uint32_t* __restrict__ words,
                 const uint8_t* __restrict__ scales, float* __restrict__ y,
                 int M, int N, int K, int k_pad, int width, int bs, lmq::BfpSpec aq) {
  extern __shared__ __align__(16) float smem[];
  const int per_word = 32 / width;
  const int tile = per_word * kSlice;
  const int nsb = tile / bs;       // scale rows per tile
  float* xs = smem;                // [tile][ROWS]: x of the current tile
  float* ss = xs + tile * ROWS;    // [nsb][kCols]: its decoded scales
  const uint32_t mask = (1u << width) - 1u;
  const int cmax = (1 << (width - 1)) - 1;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col0 = blockIdx.x * kCols;
  const int n = col0 + lane;
  const bool live = n < N;
  const int m0 = blockIdx.y * ROWS;
  const int rows = min(ROWS, M - m0);
  const int n_tiles = k_pad / tile;
  const int r0 = warp * kRowsPerWarp;  // this warp's word rows in a tile

  float acc[ROWS];
#pragma unroll
  for (int m = 0; m < ROWS; ++m) acc[m] = 0.f;

  uint32_t nxt[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
    nxt[i] = live ? __ldg(words + (size_t)(r0 + i) * N + n) : 0u;

  for (int t = 0; t < n_tiles; ++t) {
    uint32_t cur[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) cur[i] = nxt[i];
    if (t + 1 < n_tiles) {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        nxt[i] = live ? __ldg(words + (size_t)((t + 1) * kSlice + r0 + i) * N + n) : 0u;
    }
    __syncthreads();  // the previous tile's xs / ss are no longer read
    // scales: up to 8 loads in flight per thread
    for (int i0 = threadIdx.x; i0 < nsb * kCols; i0 += 8 * kThreads) {
      uint8_t e8[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * kThreads, c = col0 + i % kCols;
        e8[u] = (i < nsb * kCols && c < N)
                    ? __ldg(scales + (size_t)(t * nsb + i / kCols) * N + c) : 0;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * kThreads;
        if (i < nsb * kCols) ss[i] = scale_from_e8(e8[u]);
      }
    }
    stage_x_rows<ROWS>(xs, x, t * tile, tile, m0, rows, K, aq);  // tile % 32 == 0
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < per_word; ++j) {
      const int kb = j * kSlice + r0;  // K row (in the tile) of cur[0], slice j
      const int sh = width * j;
      if (bs >= kRowsPerWarp) {  // the warp's 16 rows share one scale block
        const float s = ss[(kb / bs) * kCols + lane];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const int code = (int)((cur[i] >> sh) & mask) - cmax;
          fma_rows<ROWS>(acc, xs + (kb + i) * ROWS, (float)code * s);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float s = ss[((kb + i) / bs) * kCols + lane];
          const int code = (int)((cur[i] >> sh) & mask) - cmax;
          fma_rows<ROWS>(acc, xs + (kb + i) * ROWS, (float)code * s);
        }
      }
    }
  }

  // combine the warps' partial sums, warp 0 first
  float* red = smem;  // [kWarps][ROWS][kCols] fits in xs (tile >= 512)
  __syncthreads();
#pragma unroll
  for (int m = 0; m < ROWS; ++m) red[(warp * ROWS + m) * kCols + lane] = acc[m];
  __syncthreads();
  for (int o = threadIdx.x; o < ROWS * kCols; o += kThreads) {
    const int m = o / kCols, c = o % kCols;
    if (m >= rows || col0 + c >= N) continue;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[(w * ROWS + m) * kCols + c];
    y[(size_t)(m0 + m) * N + col0 + c] = s;
  }
}

// ---------------------------------------------------------------- K3

template <int ROWS>
__global__ void __launch_bounds__(kThreads)
subbyte_kernel(const float* __restrict__ x, const uint32_t* __restrict__ words,
               const uint8_t* __restrict__ scales, float* __restrict__ y,
               int M, int N, int K, int k_pad, int width, int bs, lmq::BfpSpec aq) {
  extern __shared__ __align__(16) float smem[];
  const int per_word = 32 / width;
  const int tile = per_word * kSlice;
  const int nsb = tile / bs;                // scales per column and tile
  const int n_words = k_pad / per_word;     // words per column
  float* xs = smem;                         // [tile][ROWS]: x of the current tile
  float* ss = xs + tile * ROWS;             // [kCols][nsb]: its decoded scales
  const uint32_t mask = (1u << width) - 1u;
  const int cmax = (1 << (width - 1)) - 1;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col0 = blockIdx.x * kCols;
  const int c0 = warp * kColsPerWarp;  // this warp's first column in the block
  const int ncols = min(kCols, N - col0);
  const int m0 = blockIdx.y * ROWS;
  const int rows = min(ROWS, M - m0);
  const int n_tiles = k_pad / tile;

  float acc[kColsPerWarp][ROWS];
#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c)
#pragma unroll
    for (int m = 0; m < ROWS; ++m) acc[c][m] = 0.f;
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
        if (i < ncols * nsb) ss[i] = scale_from_e8(e8[u]);
      }
    }
    stage_x_rows<ROWS>(xs, x, t * tile, tile, m0, rows, K, aq);
    __syncthreads();
    if (c0 >= ncols) continue;  // a warp past N still joins the barriers
    for (int j = 0; j < per_word; ++j) {
      const int sh = width * j;
#pragma unroll
      for (int g = 0; g < kLaneWords; ++g) {
        const int kk = j * kSlice + 32 * g + lane;  // K row in the tile
        const int sb = j * slice_sb + lane_sb[g];
        float wv[kColsPerWarp];  // dequantized weights, each used for every row
#pragma unroll
        for (int c = 0; c < kColsPerWarp; ++c) {
          const int code = (int)((cur[c][g] >> sh) & mask) - cmax;
          // columns past N read a scale slot no one wrote; their sums are
          // never stored
          wv[c] = (float)code * ss[(c0 + c) * nsb + sb];
        }
#pragma unroll
        for (int m = 0; m < ROWS; m += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(xs + kk * ROWS + m);
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
    for (int m = 0; m < ROWS; ++m)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[c][m] += __shfl_down_sync(0xffffffffu, acc[c][m], o);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kColsPerWarp; ++c)
#pragma unroll
      for (int m = 0; m < ROWS; ++m)
        if (m < rows && c0 + c < ncols) y[(size_t)(m0 + m) * N + col0 + c0 + c] = acc[c][m];
  }
}

// ---------------------------------------------------------------- K2

template <int ROWS>
__global__ void __launch_bounds__(kThreads)
int8_kernel(const float* __restrict__ x, const int8_t* __restrict__ codes,
            const float* __restrict__ scales, float* __restrict__ y,
            int M, int N, int K, int k_pad, int bs, lmq::BfpSpec aq) {
  __shared__ __align__(16) float xs[ROWS * kChunk];  // [ROWS][kChunk]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col0 = blockIdx.x * kCols + warp * kColsPerWarp;  // this warp's columns
  const int m0 = blockIdx.y * ROWS;
  const int rows = min(ROWS, M - m0);
  const int nb = k_pad / bs;  // scales per weight row

  float acc[kColsPerWarp][ROWS];
#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c)
#pragma unroll
    for (int m = 0; m < ROWS; ++m) acc[c][m] = 0.f;

  for (int k0 = 0; k0 < k_pad; k0 += kChunk) {
    const int len = min(kChunk, k_pad - k0);  // a multiple of 4
    // lane: codes k0 + 128 g + 4 lane .. + 3 of each column (one scale block,
    // since bs is a multiple of 4)
    int cw[kColsPerWarp][4];
    float sc[kColsPerWarp][4];
#pragma unroll
    for (int c = 0; c < kColsPerWarp; ++c) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int kk = g * 128 + 4 * lane;
        const bool ok = col0 + c < N && kk < len;
        const size_t row = (size_t)(col0 + c);
        cw[c][g] = ok ? __ldg(reinterpret_cast<const int*>(codes + row * k_pad + k0 + kk)) : 0;
        sc[c][g] = ok ? __ldg(scales + row * nb + (k0 + kk) / bs) : 0.f;
      }
    }
    __syncthreads();  // the previous chunk's xs is no longer read
    // x: a thread loads one K position of all ROWS rows at once, the lanes of
    // a warp hold consecutive K (the activation quantizer's blocks are runs
    // of lanes)
    for (int kk = threadIdx.x; kk < kChunk; kk += kThreads) {
      const int k = k0 + kk;
      float v[ROWS];
#pragma unroll
      for (int m = 0; m < ROWS; ++m)
        v[m] = (m < rows && kk < len && k < K) ? __ldg(x + (size_t)(m0 + m) * K + k) : 0.f;
      if (aq.on) {
#pragma unroll
        for (int m = 0; m < ROWS; ++m) v[m] = lmq::bfp_qdq_lanes(v[m], aq);
      }
#pragma unroll
      for (int m = 0; m < ROWS; ++m) xs[m * kChunk + kk] = v[m];
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int kk = g * 128 + 4 * lane;
      float wv[kColsPerWarp][4];  // dequantized weights, each used for every row
#pragma unroll
      for (int c = 0; c < kColsPerWarp; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wv[c][i] = (float)(int8_t)((cw[c][g] >> (8 * i)) & 0xff) * sc[c][g];
#pragma unroll
      for (int m = 0; m < ROWS; ++m) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + m * kChunk + kk);
#pragma unroll
        for (int c = 0; c < kColsPerWarp; ++c) {
          float a = acc[c][m];
          a = fmaf(xv.x, wv[c][0], a);
          a = fmaf(xv.y, wv[c][1], a);
          a = fmaf(xv.z, wv[c][2], a);
          a = fmaf(xv.w, wv[c][3], a);
          acc[c][m] = a;
        }
      }
    }
  }

  // sum each (column, row) over the warp's lanes; lane 0 holds the result
#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c)
#pragma unroll
    for (int m = 0; m < ROWS; ++m)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[c][m] += __shfl_down_sync(0xffffffffu, acc[c][m], o);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kColsPerWarp; ++c)
#pragma unroll
      for (int m = 0; m < ROWS; ++m)
        if (m < rows && col0 + c < N) y[(size_t)(m0 + m) * N + col0 + c] = acc[c][m];
  }
}

template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int ROWS>
int launch_subbyte_t(const void* x, const void* words, const void* scales, void* y,
                     int M, int N, int K, int k_pad, int width, int bs, lmq::BfpSpec aq,
                     cudaStream_t stream) {
  const int tile = (32 / width) * kSlice;
  const int smem = 4 * (tile * ROWS + (tile / bs) * kCols);
  if (smem > kSmemMax || k_pad % tile) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_dynamic_smem(subbyte_t_kernel<ROWS>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kCols - 1) / kCols, (M + ROWS - 1) / ROWS);
  subbyte_t_kernel<ROWS><<<grid, kThreads, smem, stream>>>(
      (const float*)x, (const uint32_t*)words, (const uint8_t*)scales, (float*)y,
      M, N, K, k_pad, width, bs, aq);
  return (int)cudaGetLastError();
}

template <int ROWS>
int launch_subbyte(const void* x, const void* words, const void* scales, void* y,
                   int M, int N, int K, int k_pad, int width, int bs, lmq::BfpSpec aq,
                   cudaStream_t stream) {
  const int tile = (32 / width) * kSlice;
  const int smem = 4 * (tile * ROWS + (tile / bs) * kCols);
  if (smem > kSmemMax || k_pad % tile) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_dynamic_smem(subbyte_kernel<ROWS>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kCols - 1) / kCols, (M + ROWS - 1) / ROWS);
  subbyte_kernel<ROWS><<<grid, kThreads, smem, stream>>>(
      (const float*)x, (const uint32_t*)words, (const uint8_t*)scales, (float*)y,
      M, N, K, k_pad, width, bs, aq);
  return (int)cudaGetLastError();
}

template <int ROWS>
int launch_int8(const void* x, const void* codes, const void* scales, void* y, int M,
                int N, int K, int k_pad, int bs, lmq::BfpSpec aq, cudaStream_t stream) {
  const dim3 grid((N + kCols - 1) / kCols, (M + ROWS - 1) / ROWS);
  int8_kernel<ROWS><<<grid, kThreads, 0, stream>>>(
      (const float*)x, (const int8_t*)codes, (const float*)scales, (float*)y,
      M, N, K, k_pad, bs, aq);
  return (int)cudaGetLastError();
}

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
  // the row block never changes a row's result, only how many share a pass
  if (M <= 8) return launch_subbyte_t<8>(x, words, scales, y, M, N, K, k_pad, width, bs, aq, s);
  return launch_subbyte_t<16>(x, words, scales, y, M, N, K, k_pad, width, bs, aq, s);
}

int lmq_bfp_matmul_subbyte(const void* x, const void* words, const void* scales,
                           void* y, int M, int N, int K, int k_pad, int width,
                           int bs, int aq_on, int aq_bs, int aq_width,
                           int aq_emin, int aq_emax, void* stream) {
  const lmq::BfpSpec aq{aq_on, aq_bs, aq_width, aq_emin, aq_emax};
  if (width < 2 || width > 8 || bs < 1 || kSlice % bs || (aq_on && 32 % aq_bs))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (M <= 8) return launch_subbyte<8>(x, words, scales, y, M, N, K, k_pad, width, bs, aq, s);
  return launch_subbyte<16>(x, words, scales, y, M, N, K, k_pad, width, bs, aq, s);
}

int lmq_bfp_matmul_int8(const void* x, const void* codes, const void* scales,
                        void* y, int M, int N, int K, int k_pad, int bs,
                        int aq_on, int aq_bs, int aq_width, int aq_emin,
                        int aq_emax, void* stream) {
  const lmq::BfpSpec aq{aq_on, aq_bs, aq_width, aq_emin, aq_emax};
  if (bs < 4 || kSlice % bs || k_pad % bs || (aq_on && (32 % aq_bs || k_pad % aq_bs)))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (M <= 8) return launch_int8<8>(x, codes, scales, y, M, N, K, k_pad, bs, aq, s);
  return launch_int8<16>(x, codes, scales, y, M, N, K, k_pad, bs, aq, s);
}

}  // extern "C"
