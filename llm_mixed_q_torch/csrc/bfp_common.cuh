// Shared block-floating-point arithmetic of the Hopper kernels.
//
// Mirrors the port's plain PyTorch quantizer (ops/quantizers/block_fp.py):
// exponent = clamp(ceil(log2(block max)), emin, emax), computed exactly from
// the binary exponent; mantissa = clamp(rint(((|x| + 1e-9) / 2^e) * 2^mb),
// 0, 2^mb - 1), round half to even (rintf, never roundf); elements with
// |x| <= 1e-8 pass through unchanged. Every power of two is built from bits.
// No fast-math: divisions are IEEE-exact, so results match the plain
// version bit for bit.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lmq {

// 2^e exactly, for the whole float32 range: normals, subnormals, 0 below.
__device__ __forceinline__ float exact_exp2i(int e) {
  if (e > 128) e = 128;
  if (e >= -126) return __int_as_float((e + 127) << 23);
  if (e >= -149) return __int_as_float(1 << (e + 149));
  return 0.f;
}

// ceil(log2(m)) exactly, for finite m > 0.
__device__ __forceinline__ int ceil_log2_exact(float m) {
  int ex;
  float mant = frexpf(m, &ex);
  return mant == 0.5f ? ex - 1 : ex;
}

// Static description of a block_fp quantizer (data_in of a linear, or the
// probabilities of decode attention).
struct BfpSpec {
  int on;
  int bs;     // elements per shared exponent
  int width;  // sign + mantissa bits
  int emin;   // -exponent_bias
  int emax;   // 2^exponent_width - 1 - exponent_bias
};

// Shared exponent of a block whose abs max is block_max (> 0).
__device__ __forceinline__ int bfp_block_exp(float block_max, const BfpSpec& q) {
  return max(q.emin, min(q.emax, ceil_log2_exact(block_max)));
}

// Fake-quantize one element of a block with shared exponent e. Division by
// 2^e is a multiplication by 2^-e where both are finite floats: the exact
// quotient is the same, so the rounded one is too.
__device__ __forceinline__ float bfp_qdq_exp(float x, int e, const BfpSpec& q) {
  if (fabsf(x) <= 1e-8f) return x;
  const int mbits = q.width - 1;
  const float shift = (float)(1 << mbits);
  const float two_e = exact_exp2i(e);
  const float value = __fadd_rn(fabsf(x), 1e-9f);
  const float scaled = (e >= -127 && e <= 127) ? __fmul_rn(value, exact_exp2i(-e))
                                               : __fdiv_rn(value, two_e);
  float mant = rintf(__fmul_rn(scaled, shift));
  mant = fminf(fmaxf(mant, 0.f), (float)((1 << mbits) - 1));
  const float sign = x > 0.f ? 1.f : -1.f;
  return __fmul_rn(__fmul_rn(sign, two_e), __fmul_rn(mant, exact_exp2i(-mbits)));
}

// Fake-quantize one element given its block's abs max. A zero block takes
// the passthrough for every element, so its exponent is never used.
__device__ __forceinline__ float bfp_qdq(float x, float block_max, const BfpSpec& q) {
  if (fabsf(x) <= 1e-8f) return x;
  return bfp_qdq_exp(x, bfp_block_exp(block_max, q), q);
}

// Fake-quantize x where the lanes of a warp hold consecutive elements of
// one row and q.bs (a power of two <= 32) lanes form a block. Every lane
// of the warp must call it.
__device__ __forceinline__ float bfp_qdq_lanes(float x, const BfpSpec& q) {
  float m = fabsf(x);
  for (int o = 1; o < q.bs; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return bfp_qdq(x, m, q);
}

}  // namespace lmq
