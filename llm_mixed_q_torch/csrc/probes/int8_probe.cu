// Scale storage for the int8 dequant-matmul: probe P2.
//
// P2 replaces tools/kvariants2.py int8_variant with _int8_kernel_bf16s:
//    y[M, N] = x . w over K, w = code * s on PackedBFP's int8 codes [N, K_pad]
//    with the block scales stored as bf16 [N, K_pad / bs] (2 bytes a block
//    instead of 4), x rounded to bf16 as the TPU probe does and never
//    quantized, float32 sums. Its control instance reads float32 scales:
//    the TPU tool's base case runs K2 itself, which also differs from this
//    copy in x's staging, so the copy with each scale type isolates the
//    type.
//
// It is a copy of K2's CUDA-core design (csrc/dequant_matmul.cu's
// int8_kernel at 8 rows a block, held to its 128 registers, before K2
// moved to the tensor cores) that reads float32 or bf16 scales (widened
// to float32 by a shift) and stages bf16(x) with no quantizer; on bf16 x
// that design without its quantizer, int8_tile's c32_k512, computes the
// same sums in the same order. What bounds it on an H100, as K2: the codes
// and scales over the
// 3.35 TB/s memory rate at M = 8, 1 + 2 / bs bytes an element with bf16
// scales (float32: 1 + 4 / bs). Lanes run along K (4 codes a lane, 128 a
// warp load, coalesced), warp w takes 4 columns and reuses each x load for
// all 4; a chunk's codes and scales are loaded before its x is staged, so
// the loads overlap the staging. A lane's scale block is computed once for
// its 4 columns, outside the loads' conditions.

#include "probe_matmul.cuh"

namespace {

constexpr int kChunk = 512;  // K per step, 4 codes per lane x 4

// Scale i of the [N, k_pad / bs] array, as float32. A bf16 scale is read
// as the aligned 32-bit word that holds it, a load of the width K2 issues
// and with no condition of its own, so that ptxas keeps it ahead of the
// chunk's first barrier, as it keeps K2's float loads (16-bit loads of
// read-only data it may move past the barrier). The word of the last
// scale of an odd-sized array reaches one bf16 past its end
// (lmq_probe_int8's contract).
__device__ __forceinline__ float load_scale(const float* __restrict__ s, size_t i) {
  return __ldg(s + i);
}
__device__ __forceinline__ float load_scale(const uint16_t* __restrict__ s, size_t i) {
  const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(s + (i & ~(size_t)1)));
  return __uint_as_float(i & 1 ? w & 0xffff0000u : w << 16);
}

// S: float (float32 scales) or uint16_t (the bits of bf16 scales); 2 blocks
// an SM, as K2 (128 registers) runs
template <typename S>
__global__ void __launch_bounds__(kThreads, 2)
int8_probe_kernel(const float* __restrict__ x, const int8_t* __restrict__ codes,
                  const S* __restrict__ scales, float* __restrict__ y,
                  int M, int N, int Kx, int k_pad, int bs) {
  __shared__ __align__(16) float xs[kRows * kChunk];  // [kRows][kChunk]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col0 = blockIdx.x * kCols + warp * kColsPerWarp;  // this warp's columns
  const int m0 = blockIdx.y * kRows;
  const int rows = min(kRows, M - m0);
  const int nb = k_pad / bs;  // scales per weight row

  float acc[kColsPerWarp][kRows];
#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c)
#pragma unroll
    for (int m = 0; m < kRows; ++m) acc[c][m] = 0.f;

  for (int k0 = 0; k0 < k_pad; k0 += kChunk) {
    const int len = min(kChunk, k_pad - k0);  // a multiple of 4
    // lane: codes k0 + 128 g + 4 lane .. + 3 of each column (one scale block,
    // since bs is a multiple of 4)
    int cw[kColsPerWarp][4];
    float sc[kColsPerWarp][4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int kk = g * 128 + 4 * lane;
      const int sb = (k0 + kk) / bs;
#pragma unroll
      for (int c = 0; c < kColsPerWarp; ++c) {
        const bool ok = col0 + c < N && kk < len;
        const size_t row = (size_t)(col0 + c);
        cw[c][g] = ok ? __ldg(reinterpret_cast<const int*>(codes + row * k_pad + k0 + kk)) : 0;
        sc[c][g] = ok ? load_scale(scales, row * nb + sb) : 0.f;
      }
    }
    __syncthreads();  // the previous chunk's xs is no longer read
    // x: a thread loads one K position of all rows at once, as K2 does,
    // and rounds it to bf16 where K2 quantizes
    for (int kk = threadIdx.x; kk < kChunk; kk += kThreads) {
      const int k = k0 + kk;
      float v[kRows];
#pragma unroll
      for (int m = 0; m < kRows; ++m)
        v[m] = (m < rows && kk < len && k < Kx) ? __ldg(x + (size_t)(m0 + m) * Kx + k) : 0.f;
#pragma unroll
      for (int m = 0; m < kRows; ++m) xs[m * kChunk + kk] = bf16_round_bits(v[m]);
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
      for (int m = 0; m < kRows; ++m) {
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
    for (int m = 0; m < kRows; ++m)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[c][m] += __shfl_down_sync(0xffffffffu, acc[c][m], o);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kColsPerWarp; ++c)
#pragma unroll
      for (int m = 0; m < kRows; ++m)
        if (m < rows && col0 + c < N) y[(size_t)(m0 + m) * N + col0 + c] = acc[c][m];
  }
}

}  // namespace

extern "C" {

// x [M, Kx] (read as 0 past Kx, Kx <= k_pad), int8 codes [N, k_pad], block
// scales [N, k_pad / bs]: float32 (bf16 = 0) or bf16 (bf16 = 1: 4-byte
// aligned, and one readable bf16 past the end when N * k_pad / bs is odd)
// -> y [M, N]
int lmq_probe_int8(const void* x, const void* codes, const void* scales, void* y, int M, int N,
                   int Kx, int k_pad, int bs, int bf16, void* stream) {
  if (bs < 4 || kSlice % bs || k_pad % bs || Kx > k_pad || M < 1 || N < 1 || (bf16 >> 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kCols - 1) / kCols, (M + kRows - 1) / kRows);
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    int8_probe_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        (const float*)x, (const int8_t*)codes, (const uint16_t*)scales, (float*)y, M, N, Kx,
        k_pad, bs);
  else
    int8_probe_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)x, (const int8_t*)codes, (const float*)scales, (float*)y, M, N, Kx,
        k_pad, bs);
  return (int)cudaGetLastError();
}

}  // extern "C"
