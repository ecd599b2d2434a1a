// Column tile, K per step and K split of the int8 dequant-matmul: probes P6
// and P5.
//
// P6 replaces tools/ktune7b.py int8_call: K2's TPU kernel
//    (_dequant_matmul_kernel) on a k-innermost grid of bn output columns
//    and bk of K a step, with the cost estimate and the dimension
//    semantics on or off.
// P5 replaces tools/ktune7b.py int8_call(j_inner=True): the same product on
//    a j-innermost grid, whose output tile stays resident across the outer
//    K axis and sums one bk band of K at a time.
// Both compute y[M, N] = x . w over K on PackedBFP (int8 codes [N, K_pad],
// float32 block scales [N, K_pad / bs]), w = code * s, x rounded to bf16 as
// the TPU probes do and never quantized, float32 sums.
//
// The kernel is K2's CUDA-core design (csrc/dequant_matmul.cu's int8_kernel
// at 8 rows a block, before K2 moved to the tensor cores and to a
// prologue of its own for the quantizer) without its activation
// quantizer, templated on the Hopper knobs the TPU
// tile sizes map to (relative to K2's shipped bn 1024 / bk 1024 <-> 32 /
// 512):
//   COLS   output columns a block (COLS / 8 a warp): 8, 16, 32 or 64
//   KSTEP  K of x staged in shared memory between two barriers: 256, 512,
//          1024 or 2048. A lane still loads its codes and scales for 512 K
//          at a time (4 codes and a scale, 4 times, per column), as K2
//          does, in sub-steps of the staging step: the registers do not
//          grow with KSTEP. The first sub-step's loads are issued before
//          the step's barrier, so they overlap the staging, as K2's do.
// and a runtime K band (P5): the grid is (column blocks, bands, row blocks),
// column blocks innermost; the block of band b sums K rows b * band ..
// (b + 1) * band - 1 (the last band short) and writes its partial sums to a
// float32 workspace [bands, M, N]; band_sum_kernel then adds the bands in
// order, a second launch of this file, with no atomics, so the result does
// not depend on the schedule. COLS = 32, KSTEP = 512 with no band is that
// design without its quantizer (c32_k512, the anchor the other probe
// copies of it are held to). Lane r sums K rows 128 G + 4 r .. + 3 (G = 0,
// 1, ...) in increasing order whatever COLS and KSTEP are, so those
// instances compute c32_k512's sums bit for bit; a band instance adds its
// bands' sums instead, in another order, and K2 on the tensor cores sums
// the same products in another order too.
//
// What bounds it on an H100, as K2: the codes and scales (1 + 4 / bs bytes
// an element) over the 3.35 TB/s memory rate at M = 8, plus, with bands,
// the workspace written and read again (2 * bands * M * N * 4 bytes). The
// knobs change the grid (N / COLS blocks of 256 threads, times the bands:
// a 4096-wide projection is 128 blocks at COLS = 32 on 132 SMs, 11 * 128
// with bands of 1024 at K = 11008), the barriers (2 per KSTEP of K) and
// the shared memory (4 * 8 * KSTEP bytes: 64 KiB at 2048, dynamic).

#include "probe_matmul.cuh"

namespace {

constexpr int kLoadK = 512;  // K of one code load: 4 codes per lane x 4

// At K2's 32 columns, held to K2's 128 registers, 2 blocks an SM, as K2
// runs (the sub-step loop and the K band otherwise take ptxas to 154 and 1
// block); the other column tiles take what ptxas gives them
template <int COLS, int KSTEP>
__global__ void __launch_bounds__(kThreads, COLS == 32 ? 2 : 1)
int8_tile_kernel(const float* __restrict__ x, const int8_t* __restrict__ codes,
                 const float* __restrict__ scales, float* __restrict__ out,
                 int M, int N, int Kx, int k_pad, int bs, int band) {
  constexpr int kCpw = COLS / kWarps;                      // columns a warp
  constexpr int kSub = KSTEP < kLoadK ? KSTEP : kLoadK;    // K of a sub-step
  constexpr int kGroups = kSub / 128;                      // 128-K groups a sub-step
  extern __shared__ __align__(16) float xs_i8[];          // [kRows][KSTEP]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col0 = blockIdx.x * COLS + warp * kCpw;  // this warp's columns
  const int kb0 = blockIdx.y * band;                 // this block's K band
  const int kb1 = min(k_pad, kb0 + band);
  const int m0 = blockIdx.z * kRows;
  const int rows = min(kRows, M - m0);
  const int nb = k_pad / bs;  // scales per weight row
  float* y = out + (size_t)blockIdx.y * M * N;  // the band's partial sums (y with one band)

  float acc[kCpw][kRows];
#pragma unroll
  for (int c = 0; c < kCpw; ++c)
#pragma unroll
    for (int m = 0; m < kRows; ++m) acc[c][m] = 0.f;

  for (int k0 = kb0; k0 < kb1; k0 += KSTEP) {
    const int len = min(KSTEP, kb1 - k0);  // a multiple of 4
    for (int s0 = 0; s0 < len; s0 += kSub) {
      // lane: codes k0 + s0 + 128 g + 4 lane .. + 3 of each column (one
      // scale block, since bs is a multiple of 4)
      int cw[kCpw][kGroups];
      float sc[kCpw][kGroups];
#pragma unroll
      for (int c = 0; c < kCpw; ++c) {
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const int kk = s0 + g * 128 + 4 * lane;
          const bool ok = col0 + c < N && kk < len;
          const size_t row = (size_t)(col0 + c);
          cw[c][g] = ok ? __ldg(reinterpret_cast<const int*>(codes + row * k_pad + k0 + kk)) : 0;
          sc[c][g] = ok ? __ldg(scales + row * nb + (k0 + kk) / bs) : 0.f;
        }
      }
      if (s0 == 0) {
        __syncthreads();  // the previous step's xs is no longer read
        // x: a thread loads one K position of all rows at once, as K2 does,
        // and rounds it to bf16 where K2 quantizes
        for (int kk = threadIdx.x; kk < KSTEP; kk += kThreads) {
          const int k = k0 + kk;
          float v[kRows];
#pragma unroll
          for (int m = 0; m < kRows; ++m)
            v[m] = (m < rows && kk < len && k < Kx) ? __ldg(x + (size_t)(m0 + m) * Kx + k) : 0.f;
#pragma unroll
          for (int m = 0; m < kRows; ++m) xs_i8[m * KSTEP + kk] = bf16_round_bits(v[m]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int kk = s0 + g * 128 + 4 * lane;
        float wv[kCpw][4];  // dequantized weights, each used for every row
#pragma unroll
        for (int c = 0; c < kCpw; ++c)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            wv[c][i] = (float)(int8_t)((cw[c][g] >> (8 * i)) & 0xff) * sc[c][g];
#pragma unroll
        for (int m = 0; m < kRows; ++m) {
          const float4 xv = *reinterpret_cast<const float4*>(xs_i8 + m * KSTEP + kk);
#pragma unroll
          for (int c = 0; c < kCpw; ++c) {
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
        if (m < rows && col0 + c < N) y[(size_t)(m0 + m) * N + col0 + c] = acc[c][m];
  }
}

// y[i] = ws[0][i] + ws[1][i] + ... + ws[bands - 1][i], in that order
__global__ void __launch_bounds__(kThreads)
band_sum_kernel(const float* __restrict__ ws, float* __restrict__ y, int bands, int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kThreads) {
    float s = ws[i];
    for (int b = 1; b < bands; ++b) s += ws[b * n + i];
    y[i] = s;
  }
}

using Int8Kernel = void (*)(const float*, const int8_t*, const float*, float*, int, int, int,
                            int, int, int);

// the instances of the library: (COLS, KSTEP) of P6 (and P5: 32, 512)
Int8Kernel int8_tile(int cols, int kstep) {
#define LMQ_INT8_CASE(C, S) \
  if (cols == C && kstep == S) return int8_tile_kernel<C, S>;
  LMQ_INT8_CASE(32, 512) LMQ_INT8_CASE(16, 512) LMQ_INT8_CASE(32, 256) LMQ_INT8_CASE(64, 256)
  LMQ_INT8_CASE(16, 1024) LMQ_INT8_CASE(16, 2048) LMQ_INT8_CASE(8, 2048)
#undef LMQ_INT8_CASE
  return nullptr;
}

}  // namespace

extern "C" {

// x [M, Kx] (read as 0 past Kx, Kx <= k_pad), int8 codes [N, k_pad], float32
// block scales [N, k_pad / bs], by instance (cols, kstep). band = k_pad: y
// [M, N]; band < k_pad (a multiple of 128): the workspace [ceil(k_pad /
// band), M, N] of the bands' partial sums, for lmq_probe_band_sum
int lmq_probe_int8_tile(const void* x, const void* codes, const void* scales, void* out, int M,
                        int N, int Kx, int k_pad, int bs, int cols, int kstep, int band,
                        void* stream) {
  const Int8Kernel kernel = int8_tile(cols, kstep);
  if (kernel == nullptr || bs < 4 || kSlice % bs || k_pad % bs || Kx > k_pad || M < 1 ||
      N < 1 || band < 1 || (band < k_pad && band % kSlice))
    return (int)cudaErrorInvalidValue;
  const int smem = 4 * kRows * kstep;
  const cudaError_t err = allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + cols - 1) / cols, (k_pad + band - 1) / band, (M + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      (const float*)x, (const int8_t*)codes, (const float*)scales, (float*)out, M, N, Kx, k_pad,
      bs, band);
  return (int)cudaGetLastError();
}

// ws [bands, n] float32 -> y [n], each element summed over the bands in order
int lmq_probe_band_sum(const void* ws, void* y, int bands, int64_t n, void* stream) {
  if (bands < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  band_sum_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>((const float*)ws, (float*)y, bands, n);
  return (int)cudaGetLastError();
}

// blocks of instance (cols, kstep) that fit on one SM -> *blocks (a host int)
int lmq_probe_int8_tile_occupancy(int cols, int kstep, void* blocks) {
  const Int8Kernel kernel = int8_tile(cols, kstep);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const int smem = 4 * kRows * kstep;
  cudaError_t err = allow_dynamic_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(static_cast<int*>(blocks), kernel,
                                                        kThreads, smem);
  return (int)err;
}

}  // extern "C"
