// Column tile and tiles per step of the lane-major sub-byte matmul: probes
// P4 and P7.
//
// P4 replaces tools/kprobe.py subbyte_call: K3's TPU kernel
//    (_subbyte_kernel) on grids of bn output columns a step, with the
//    dimension semantics and the cost estimate on or off.
// P7 replaces tools/ktune7b.py sub_call: the same product with ks packing
//    tiles of K a grid step.
// Both compute y[M, N] = x . w over K on PackedBFPSub (words [N, K_pad /
// per_word], bits width*j of word t*128 + r holding K row t*tile + j*128 +
// r; uint8 scale exponents [n_tiles, N, tile / bs]), w = (code - cmax) *
// 2^clip(e8 - 128, -126, 127), x rounded to bf16 as the TPU probes do and
// never quantized, float32 sums.
//
// The kernel is K3's former CUDA-core design (csrc/dequant_matmul.cu's
// subbyte_kernel at 8 rows a block, before it moved to the tensor cores)
// without its activation quantizer, templated on the two Hopper knobs the
// TPU tile sizes map to:
//   COLS  output columns a block (COLS / 8 a warp): 8, 16, 32 or 64; a
//         TPU bn maps relative to K3's shipped 2048 <-> 32
//   TPS   packing tiles whose x and decoded scales are staged between two
//         barriers: 1, 2 or 4 (the TPU's ks)
// COLS = 32, TPS = 1 (c32_t1) is that design without its quantizer, the
// anchor the lane-major probe copies are held to. The words stay that
// design's: a warp keeps the next tile's words in registers, one tile
// ahead, whatever TPS is. Where TPS does not divide the tile count the last
// step is short (the TPU's sub_call shrinks ks until it divides instead,
// which at width 6 and K = 4096, 7 tiles, runs every ks as 1). Each lane
// sums its K rows in c32_t1's order and the warps' lanes are combined as
// c32_t1 combines them, so every instance computes c32_t1's sums bit for
// bit.
//
// What bounds it on an H100, as K3: the packed weight bytes (~6.9 bits an
// element at width 6, block 16) over the 3.35 TB/s memory rate at M = 8.
// The knobs change the grid: N / COLS blocks of 256 threads, so a 4096-wide
// projection is 512 blocks at COLS = 8 and 64 at COLS = 64 on 132 SMs; and
// the barriers, 2 per TPS tiles. Registers grow with COLS (COLS / 8 columns
// of 8 accumulators and 2 x 4 words in flight a lane), shared memory with
// TPS (4 * TPS * (tile * 8 + COLS * tile / bs) bytes).

#include "probe_matmul.cuh"

namespace {

template <int COLS, int TPS>
__global__ void __launch_bounds__(kThreads)
subbyte_tile_kernel(const float* __restrict__ x, const uint32_t* __restrict__ words,
                    const uint8_t* __restrict__ scales, float* __restrict__ y,
                    int M, int N, int Kx, int k_pad, int width, int bs) {
  constexpr int kCpw = COLS / kWarps;  // columns a warp
  extern __shared__ __align__(16) float smem_tile[];
  const int per_word = 32 / width;
  const int tile = per_word * kSlice;
  const int nsb = tile / bs;                // scales per column and tile
  const int n_words = k_pad / per_word;     // words per column
  float* xs = smem_tile;                    // [TPS][tile][kRows]: bf16(x) of the step's tiles
  float* ss = xs + TPS * tile * kRows;      // [TPS][COLS][nsb]: their decoded scales
  const uint32_t mask = (1u << width) - 1u;
  const int cmax = (1 << (width - 1)) - 1;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col0 = blockIdx.x * COLS;
  const int c0 = warp * kCpw;  // this warp's first column in the block
  const int ncols = min(COLS, N - col0);
  const int m0 = blockIdx.y * kRows;
  const int rows = min(kRows, M - m0);
  const int n_tiles = k_pad / tile;

  float acc[kCpw][kRows];
#pragma unroll
  for (int c = 0; c < kCpw; ++c)
#pragma unroll
    for (int m = 0; m < kRows; ++m) acc[c][m] = 0.f;
  // scale slot of K row j*128 + 32g + lane: j * slice_sb + lane_sb[g]
  const int slice_sb = kSlice / bs;
  int lane_sb[kLaneWords];
#pragma unroll
  for (int g = 0; g < kLaneWords; ++g) lane_sb[g] = (32 * g + lane) / bs;

  // nxt[c][g]: word row 32g + lane of the next tile, column c0 + c
  uint32_t nxt[kCpw][kLaneWords];
#pragma unroll
  for (int c = 0; c < kCpw; ++c)
#pragma unroll
    for (int g = 0; g < kLaneWords; ++g)
      nxt[c][g] = c0 + c < ncols
                      ? __ldg(words + (size_t)(col0 + c0 + c) * n_words + 32 * g + lane) : 0u;

  for (int t0 = 0; t0 < n_tiles; t0 += TPS) {
    const int n_step = min(TPS, n_tiles - t0);  // tiles of this step: the last may be short
    for (int u = 0; u < n_step; ++u) {
      const int t = t0 + u;
      uint32_t cur[kCpw][kLaneWords];
#pragma unroll
      for (int c = 0; c < kCpw; ++c)
#pragma unroll
        for (int g = 0; g < kLaneWords; ++g) cur[c][g] = nxt[c][g];
      if (t + 1 < n_tiles) {
#pragma unroll
        for (int c = 0; c < kCpw; ++c)
#pragma unroll
          for (int g = 0; g < kLaneWords; ++g)
            nxt[c][g] = c0 + c < ncols
                            ? __ldg(words + (size_t)(col0 + c0 + c) * n_words +
                                    (t + 1) * kSlice + 32 * g + lane) : 0u;
      }
      if (u == 0) {
        __syncthreads();  // the previous step's xs / ss are no longer read
        // scales: the block's columns of tile t0 + v are ncols * nsb
        // consecutive bytes; up to 8 loads in flight per thread
        for (int v = 0; v < n_step; ++v) {
          const uint8_t* st = scales + ((size_t)(t0 + v) * N + col0) * nsb;
          float* sv = ss + v * COLS * nsb;
          for (int i0 = threadIdx.x; i0 < ncols * nsb; i0 += 8 * kThreads) {
            uint8_t e8[8];
#pragma unroll
            for (int w = 0; w < 8; ++w) {
              const int i = i0 + w * kThreads;
              e8[w] = i < ncols * nsb ? __ldg(st + i) : 0;
            }
#pragma unroll
            for (int w = 0; w < 8; ++w) {
              const int i = i0 + w * kThreads;
              if (i < ncols * nsb) sv[i] = probe_scale(e8[w]);
            }
          }
        }
        // x of the step's tiles, K rows t0 * tile .. (t0 + n_step) * tile - 1:
        // a thread loads one K position of every row at once
        for (int kk = threadIdx.x; kk < n_step * tile; kk += kThreads) {
          const int k = t0 * tile + kk;
          float v[kRows];
#pragma unroll
          for (int m = 0; m < kRows; ++m)
            v[m] = (m < rows && k < Kx) ? bf16_round_bits(__ldg(x + (size_t)(m0 + m) * Kx + k))
                                        : 0.f;
#pragma unroll
          for (int m = 0; m < kRows; m += 4)
            *reinterpret_cast<float4*>(xs + kk * kRows + m) =
                make_float4(v[m], v[m + 1], v[m + 2], v[m + 3]);
        }
        __syncthreads();
      }
      if (c0 >= ncols) continue;  // a warp past N still joins the barriers
      const float* xt = xs + u * tile * kRows;
      const float* st = ss + u * COLS * nsb;
      for (int j = 0; j < per_word; ++j) {
        const int sh = width * j;
#pragma unroll
        for (int g = 0; g < kLaneWords; ++g) {
          const int kk = j * kSlice + 32 * g + lane;  // K row in the tile
          const int sb = j * slice_sb + lane_sb[g];
          float wv[kCpw];  // dequantized weights, each used for every row
#pragma unroll
          for (int c = 0; c < kCpw; ++c) {
            const int code = (int)((cur[c][g] >> sh) & mask) - cmax;
            // columns past N read a scale slot no one wrote; their sums are
            // never stored
            wv[c] = (float)code * st[(c0 + c) * nsb + sb];
          }
#pragma unroll
          for (int m = 0; m < kRows; m += 4) {
            const float4 xv = *reinterpret_cast<const float4*>(xt + kk * kRows + m);
#pragma unroll
            for (int c = 0; c < kCpw; ++c) {
              acc[c][m] = fmaf(xv.x, wv[c], acc[c][m]);
              acc[c][m + 1] = fmaf(xv.y, wv[c], acc[c][m + 1]);
              acc[c][m + 2] = fmaf(xv.z, wv[c], acc[c][m + 2]);
              acc[c][m + 3] = fmaf(xv.w, wv[c], acc[c][m + 3]);
            }
          }
        }
      }
    }
  }

  // sum each (column, row) over the warp's lanes; lane 0 holds the result
#pragma unroll
  for (int c = 0; c < kCpw; ++c)
#pragma unroll
    for (int m = 0; m < kRows; ++m)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[c][m] += __shfl_down_sync(0xffffffffu, acc[c][m], o);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kCpw; ++c)
#pragma unroll
      for (int m = 0; m < kRows; ++m)
        if (m < rows && c0 + c < ncols) y[(size_t)(m0 + m) * N + col0 + c0 + c] = acc[c][m];
  }
}

using TileKernel = void (*)(const float*, const uint32_t*, const uint8_t*, float*, int, int,
                            int, int, int, int);

// the instances of the library: (COLS, TPS) of P4 (TPS = 1) and P7
TileKernel tile_kernel(int cols, int tps) {
#define LMQ_TILE_CASE(C, T) \
  if (cols == C && tps == T) return subbyte_tile_kernel<C, T>;
  LMQ_TILE_CASE(32, 1) LMQ_TILE_CASE(16, 1) LMQ_TILE_CASE(8, 1) LMQ_TILE_CASE(64, 1)
  LMQ_TILE_CASE(32, 2) LMQ_TILE_CASE(16, 2) LMQ_TILE_CASE(16, 4) LMQ_TILE_CASE(64, 2)
#undef LMQ_TILE_CASE
  return nullptr;
}

int tile_smem_bytes(int cols, int tps, int width, int bs) {
  const int tile = (32 / width) * kSlice;
  return 4 * tps * (tile * kRows + cols * (tile / bs));
}

}  // namespace

extern "C" {

// x [M, Kx] (read as 0 past Kx, Kx <= k_pad), lane-major words, uint8
// scale exponents -> y [M, N], by instance (cols, tps)
int lmq_probe_subbyte_tile(const void* x, const void* words, const void* scales, void* y,
                           int M, int N, int Kx, int k_pad, int width, int bs, int cols, int tps,
                           void* stream) {
  const TileKernel kernel = tile_kernel(cols, tps);
  if (kernel == nullptr || width < 2 || width > 8 || bs < 1 || kSlice % bs || Kx > k_pad ||
      M < 1 || N < 1 || k_pad % ((32 / width) * kSlice))
    return (int)cudaErrorInvalidValue;
  const int smem = tile_smem_bytes(cols, tps, width, bs);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + cols - 1) / cols, (M + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      (const float*)x, (const uint32_t*)words, (const uint8_t*)scales, (float*)y, M, N, Kx,
      k_pad, width, bs);
  return (int)cudaGetLastError();
}

// blocks of instance (cols, tps) that fit on one SM at width / bs ->
// *blocks (a host int)
int lmq_probe_subbyte_tile_occupancy(int width, int bs, int cols, int tps, void* blocks) {
  const TileKernel kernel = tile_kernel(cols, tps);
  if (kernel == nullptr || width < 2 || width > 8 || bs < 1 || kSlice % bs)
    return (int)cudaErrorInvalidValue;
  const int smem = tile_smem_bytes(cols, tps, width, bs);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_dynamic_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(static_cast<int*>(blocks), kernel,
                                                        kThreads, smem);
  return (int)err;
}

}  // extern "C"
