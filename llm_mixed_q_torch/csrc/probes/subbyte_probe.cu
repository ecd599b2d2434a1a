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
// knocked out (the lane-major one of K3's former CUDA-core design, which
// subbyte_tile's c32_t1 keeps); the production kernels are untouched. Variants, with the
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
// 256 threads, 2 blocks an SM); the lane-major copy runs K3's former design
// (lanes along K, 4 columns a warp, the next tile's words in registers,
// float32 FMAs).
// Both take 8 rows of x a block (ksub's M). The copies differ from their
// production kernels in x alone: no quantizer, x rounded to bf16 (and K1's
// lo term of raw float32 x dropped). Their body, shared with P1 and P3, is
// probe_matmul.cuh.

#include "probe_matmul.cuh"

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
