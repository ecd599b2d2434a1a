// The scale expansion of a block-scaled dequant: probe P10.
//
// P10 replaces tools/kexp.py make_call / kernel, the TPU's shoot-out of
//    the primitives that expand per-block scales [8, L] along the 128
//    sublanes of codes [128, L] (one-hot dot, 3-D broadcasts, repeat, a
//    roll fill). The expansion sits inside K2, K3 and K4; on Hopper it is
//    an index, s[k / 16]. The probe prices that index against no dequant
//    at all and against an expansion staged in shared memory.
//
// out[b] = bf16(q[b]) [8, 128] @ w[b] [128, L] -> float32 [B, 8, L], with
// w = codes [128, L] int8 times the scales [8, L] float32 taken to bf16 (as
// every TPU variant takes them) and expanded along the 128 rows in blocks
// of 16. One block per (tile of kTile columns, batch element); a thread
// holds kCols adjacent columns and all 8 rows of q, and sums k = 0..127 in
// order with fmaf. Every product bf16(q) * code * bf16(scale) is exact in
// float32 (8 + 8 + 8 significant bits at most), so the result equals the
// plain version, which sums in the same order, bit for bit. Instances:
//   none    w = code: the scales are loaded (the TPU kernel still DMAs
//           them) but not applied;
//   index   w = code * s[k / 16], the scale in a register for its 16 rows:
//           how K4 expands (csrc/attention_decode.cu);
//   staged  the block first writes the expanded scales [128, kTile] to
//           shared memory in bf16 (each scale read once, written 16
//           times), then multiplies from there: the Hopper counterpart of
//           the TPU's materialised forms.
//
// What bounds it on an H100: the bytes, codes + scales + q + the float32
// output (about 50 MB at L = 8192, B = 32), over 3.35 TB/s; the FMAs
// (2 * B * 8 * 128 * L operations) are a fifth of that time at the
// float32 rate. Loads are 4 codes (char4) and 4 scales (float4) a thread,
// a warp reading 128 contiguous bytes of a row.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;     // rows of q
constexpr int kDepth = 128;  // rows of codes (the dot's depth)
constexpr int kBlock = 16;   // rows a scale covers
constexpr int kThreads = 64;
constexpr int kCols = 4;     // adjacent columns a thread holds
constexpr int kTile = kThreads * kCols;
constexpr int kStagedSmem = kDepth * kTile * 2;  // bf16 [128][kTile]

enum Variant { kNone = 0, kIndex, kStaged };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// kCols values of a row from column l: one vector load, or (VEC false:
// the last tile, or rows not aligned for it) one load a column, 0 past the
// row's end. VEC is a template argument so that the k loop holds no branch
// and the compiler can issue a block's 16 loads of codes at once.
template <bool VEC>
__device__ __forceinline__ void load_codes(const int8_t* row, int l, int L, float (&c)[kCols]) {
  if constexpr (VEC) {
    const char4 v = *reinterpret_cast<const char4*>(row + l);
    c[0] = v.x, c[1] = v.y, c[2] = v.z, c[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j) c[j] = l + j < L ? (float)row[l + j] : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void load_scales(const float* row, int l, int L, float (&s)[kCols]) {
  if constexpr (VEC) {
    const float4 v = *reinterpret_cast<const float4*>(row + l);
    s[0] = v.x, s[1] = v.y, s[2] = v.z, s[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = l + j < L ? row[l + j] : 0.f;
  }
}

// The kCols columns of one thread from column l: out[8][l..l+kCols) of one
// batch element. zero: 0.0 from the caller. none folds the bits of every
// scale it loads into the output as fmaf(zero, bits & 1, acc): the compiler
// cannot know that zero is 0, so it keeps every scale load; with zero = 0
// this adds +0 to a sum that is never -0 (it starts at +0), which leaves
// it unchanged.
template <int V, bool VEC>
__device__ __forceinline__ void expand_columns(const float* qs, const int8_t* cb, const float* sb,
                                               const __nv_bfloat16* sexp, float* ob, int l,
                                               int t0, int L, float zero) {
  float acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;
  uint32_t sink = 0;
  for (int kb = 0; kb < kDepth / kBlock; ++kb) {
    float s[kCols];
    if constexpr (V != kStaged) load_scales<VEC>(sb + (size_t)kb * L, l, L, s);
    if constexpr (V == kNone) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) sink ^= __float_as_uint(s[j]);
    }
    if constexpr (V == kIndex) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[j] = bf16_round(s[j]);
    }
#pragma unroll
    for (int kk = 0; kk < kBlock; ++kk) {
      const int k = kb * kBlock + kk;
      float w[kCols];
      load_codes<VEC>(cb + (size_t)k * L, l, L, w);
      if constexpr (V == kIndex) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) w[j] *= s[j];
      }
      if constexpr (V == kStaged) {
        const uint2 raw = *reinterpret_cast<const uint2*>(sexp + k * kTile + t0);
        const __nv_bfloat162 s01 = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
        const __nv_bfloat162 s23 = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
        w[0] *= __low2float(s01), w[1] *= __high2float(s01);
        w[2] *= __low2float(s23), w[3] *= __high2float(s23);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qv = qs[r * kDepth + k];
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[r][j] = fmaf(qv, w[j], acc[r][j]);
      }
    }
  }

  const float keep = V == kNone ? (float)(sink & 1u) : 0.f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float* orow = ob + (size_t)r * L;
    float o[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) o[j] = V == kNone ? fmaf(zero, keep, acc[r][j]) : acc[r][j];
    if constexpr (VEC) {
      *reinterpret_cast<float4*>(orow + l) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (l + j < L) orow[l + j] = o[j];
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
expand_probe_kernel(const float* __restrict__ q, const int8_t* __restrict__ codes,
                    const float* __restrict__ scales, float* __restrict__ out, int L, int vec,
                    float zero) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sexp = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // staged: [kDepth][kTile]
  __shared__ float qs[kRows * kDepth];
  const int b = blockIdx.y, tid = threadIdx.x;
  const int l0 = blockIdx.x * kTile;
  const int8_t* cb = codes + (size_t)b * kDepth * L;
  const float* sb = scales + (size_t)b * (kDepth / kBlock) * L;
  for (int i = tid; i < kRows * kDepth; i += kThreads)
    qs[i] = bf16_round(q[(size_t)b * kRows * kDepth + i]);
  if constexpr (V == kStaged) {
    for (int i = tid; i < (kDepth / kBlock) * kTile; i += kThreads) {
      const int kb = i / kTile, t = i % kTile, l = l0 + t;
      const __nv_bfloat16 v = __float2bfloat16_rn(l < L ? sb[(size_t)kb * L + l] : 0.f);
#pragma unroll
      for (int kk = 0; kk < kBlock; ++kk) sexp[(kb * kBlock + kk) * kTile + t] = v;
    }
  }
  __syncthreads();

  const int t0 = tid * kCols, l = l0 + t0;
  float* ob = out + (size_t)b * kRows * L;
  if (vec && l + kCols <= L) {
    expand_columns<V, true>(qs, cb, sb, sexp, ob, l, t0, L, zero);
  } else {
    expand_columns<V, false>(qs, cb, sb, sexp, ob, l, t0, L, zero);
  }
}

template <int V>
int launch(const void* q, const void* codes, const void* scales, void* out, int B, int L,
           int vec, cudaStream_t stream) {
  const int smem = V == kStaged ? kStagedSmem : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        expand_probe_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((L + kTile - 1) / kTile, B);
  expand_probe_kernel<V><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const int8_t*)codes, (const float*)scales, (float*)out, L, vec, 0.f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, 8, 128] float32, codes [B, 128, L] int8, scales [B, 8, L] float32,
// out [B, 8, L] float32; variant: 0 none, 1 index, 2 staged
int lmq_probe_expand(const void* q, const void* codes, const void* scales, void* out, int B,
                     int L, int variant, void* stream) {
  if (B < 1 || L < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  // vector loads and stores: rows start 16-byte aligned for float4 scales
  // and outputs, 4-byte aligned for char4 codes
  const int vec = L % kCols == 0 && (uintptr_t)codes % 4 == 0 && (uintptr_t)scales % 16 == 0 &&
                  (uintptr_t)out % 16 == 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kNone: return launch<kNone>(q, codes, scales, out, B, L, vec, s);
    case kIndex: return launch<kIndex>(q, codes, scales, out, B, L, vec, s);
    case kStaged: return launch<kStaged>(q, codes, scales, out, B, L, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
