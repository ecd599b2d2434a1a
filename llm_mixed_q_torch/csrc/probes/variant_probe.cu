// Dequant-arithmetic and scale-storage variants of the sub-byte
// dequant-matmul: probes P1 and P3, on both sub-byte layouts.
//
// P1 replaces tools/kvariants.py matmul_variant with _kernel_v2 and
//    _kernel_v3 (y[M, N] = x . w over K, float32 sums; scales are the
//    uint8 exponent bytes, decoded as P8/P9's ship decodes them,
//    2^clip(e8 - 128, -126, 127)):
//      v2       w = bf16(code - cmax) * bf16(s), the product in bf16
//               arithmetic (int -> bf16 conversions, one __hmul2 a pair)
//      v3       w = bf16(c_b) * bf16(s) on the stored (biased) field c_b,
//               no per-element subtract; y = x . w - cmax * sum over blocks
//               of (sum of x over the block) * s: one correction per row,
//               column and block (on the transposed layout per run of the
//               block's rows a k-step holds)
// P3 replaces tools/kvariants2.py sub_variant with _sub_kernel_v4: scales
//    stored decoded in the exponent bytes' shape, float32 (v4_f32s) or bf16
//    (v4_bf16s), read as they are stored:
//      v4       w = fma(c_b, s, -cmax * s)
// x is rounded to bf16, as the TPU probes do (xs.astype(bf16)), and never
// quantized. The TPU tools read PackedBFPSub.scales as float32 scales, as
// they were when the tools were written; the bytes they hold today are
// decoded here (P1) or by the wrapper (P3).
//
// Every weight is exact (codes times powers of two), so v2 and v4 compute
// ship's product; v3 differs from it by its correction's rounding. What
// bounds them on an H100, as K1 and K3: the packed bytes over the 3.35 TB/s
// memory rate at M = 8, the scales at 1 (v2, v3), 4 (v4_f32s) or 2
// (v4_bf16s) bytes a block. The bodies are the copies of K1 (transposed:
// mma.sync on bf16 operands; v2/v3 form the A fragment's pairs with bf16x2
// multiplies) and of K3's former design (lane-major: float32 FMAs; v2 multiplies the
// weights of two columns in one bf16x2 multiply) in probe_matmul.cuh. v3
// keeps x's block sums beside the bf16 x of a tile: on the transposed layout
// summed as x is staged (a butterfly over the lanes of a run of rows) and
// added per k-step, on the lane-major one summed as x is staged and added
// once per tile, the runs spread over the lanes. The variant kernels take
// blocks of 4 or more.

#include "probe_matmul.cuh"

extern "C" {

// layout: 0 transposed, 1 lane-major; variant: 0 v2, 1 v3 (uint8 scale
// bytes), 2 v4_f32s (float32 scales), 3 v4_bf16s (bf16 scales). x is
// [M, Kx], read as 0 past Kx (Kx <= k_pad).
int lmq_probe_variant(const void* x, const void* words, const void* scales, void* y, int M,
                      int N, int Kx, int k_pad, int width, int bs, int layout, int variant,
                      void* stream) {
  if (width < 2 || width > 8 || bs < 4 || kSlice % bs || Kx > k_pad || M < 1 || N < 1 ||
      (layout != kTransposed && layout != kLaneMajor))
    return (int)cudaErrorInvalidValue;
  const Args a{x, words, scales, y, M, N, Kx, k_pad, width, bs,
               static_cast<cudaStream_t>(stream)};
  switch (variant) {
    case 0: return launch_variant<kV2>(layout, a);
    case 1: return launch_variant<kV3>(layout, a);
    case 2: return launch_variant<kV4F32>(layout, a);
    case 3: return launch_variant<kV4Bf16>(layout, a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
