// Host-side block-floating-point pack engine of the PyTorch port (its own
// copy of the JAX package's engine, with the same C interface).
//
// Quantizes and packs float32 weights [out, in] into BFP storage, int8
// codes or sub-byte codes interleaved into uint32 words, on the host with
// one thread per run of rows. The packed bytes are what cross to the card
// (models/pack_common.py, host=True), and what a search trial repacks.
//
// The math is the port's torch packer's (kernels/packing.py:
// _bfp_encode_blocked), bit for bit:
//   per-block max m (a block with m == 0 takes the least nonzero block max
//   of the tensor, or 1 when there is none);
//   exponent e = clamp(ceil(log2(m)), emin, emax), the EXACT ceil-log2 from
//   the binary exponent (frexp), not a rounded float log2;
//   scale = 2^(e - mantissa_bits), exact (ldexp), subnormals included;
//   code = 0 where |x| <= 1e-8, else
//          sign(x) * clip(round_half_even((|x| + 1e-9) / 2^e * 2^mb),
//                         0, 2^mb - 1).
// Subnormal inputs are kept, as IEEE arithmetic and torch keep them.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o libbfp_pack.so bfp_pack.cc -lpthread

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

struct BfpParams {
  int mantissa_bits;  // width - 1
  int exp_min;
  int exp_max;
};

BfpParams make_params(int width, int exponent_width, int exponent_bias) {
  BfpParams p;
  p.mantissa_bits = width - 1;
  if (exponent_bias < 0) exponent_bias = (1 << (exponent_width - 1)) - 1;
  p.exp_max = (1 << exponent_width) - 1 - exponent_bias;
  p.exp_min = -exponent_bias;
  return p;
}

// exact ceil(log2(m)) for finite m > 0
int ceil_log2(float m) {
  int ex;
  const float mant = std::frexp(m, &ex);  // m = mant * 2^ex, mant in [0.5, 1)
  return mant == 0.5f ? ex - 1 : ex;
}

float block_max(const float* xb, int block) {
  float m = 0.0f;
  for (int i = 0; i < block; ++i) m = std::max(m, std::fabs(xb[i]));
  return m;
}

// One row of blocks: `in_padded` elements (zero-padded by the caller) ->
// int8 codes + per-block scales. `zero_fill` replaces the max of an
// all-zero block.
void quantize_row(const float* w, int64_t in_padded, int block,
                  const BfpParams& p, float zero_fill, int8_t* codes,
                  float* scales) {
  const float mantissa_max = static_cast<float>((1 << p.mantissa_bits) - 1);
  const float mscale = static_cast<float>(1 << p.mantissa_bits);
  const int64_t nb = in_padded / block;
  for (int64_t b = 0; b < nb; ++b) {
    const float* xb = w + b * block;
    float pbm = block_max(xb, block);
    if (pbm == 0.0f) pbm = zero_fill;
    const int e = std::isinf(pbm) ? p.exp_max
                                  : std::clamp(ceil_log2(pbm), p.exp_min, p.exp_max);
    const float two_e = std::ldexp(1.0f, e);
    scales[b] = std::ldexp(1.0f, e - p.mantissa_bits);
    int8_t* cb = codes + b * block;
    for (int i = 0; i < block; ++i) {
      const float x = xb[i];
      const float a = std::fabs(x);
      if (a <= 1e-8f) {
        cb[i] = 0;
        continue;
      }
      float m = std::nearbyint((a + 1e-9f) / two_e * mscale);
      m = std::min(std::max(m, 0.0f), mantissa_max);
      cb[i] = static_cast<int8_t>(x > 0.0f ? m : -m);
    }
  }
}

// The least nonzero block max of the tensor (1 when every block is zero).
float compute_zero_fill(const float* w, int64_t out, int64_t in_padded,
                        int block) {
  float fill = INFINITY;
  const int64_t n = out * in_padded;
  for (int64_t i = 0; i < n; i += block) {
    const float m = block_max(w + i, block);
    if (m > 0.0f && m < fill) fill = m;
  }
  return std::isinf(fill) ? 1.0f : fill;
}

void parallel_rows(int64_t out, int n_threads,
                   const std::function<void(int64_t, int64_t)>& fn) {
  if (n_threads <= 1 || out < 2) {
    fn(0, out);
    return;
  }
  std::vector<std::thread> workers;
  const int64_t chunk = (out + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min(out, lo + chunk);
    if (lo >= hi) break;
    workers.emplace_back(fn, lo, hi);
  }
  for (auto& th : workers) th.join();
}

}  // namespace

extern "C" {

// int8 codes (one byte an element) + float32 per-block scales.
// w: [out, in_padded] row-major, in_padded a multiple of block.
// codes: [out, in_padded]; scales: [out, in_padded / block].
void bfp_pack_int8(const float* w, int64_t out, int64_t in_padded, int width,
                   int exponent_width, int exponent_bias, int block,
                   int8_t* codes, float* scales, int n_threads) {
  const BfpParams p = make_params(width, exponent_width, exponent_bias);
  const float zero_fill = compute_zero_fill(w, out, in_padded, block);
  const int64_t nb = in_padded / block;
  parallel_rows(out, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      quantize_row(w + r * in_padded, in_padded, block, p, zero_fill,
                   codes + r * in_padded, scales + r * nb);
    }
  });
}

// Sub-byte codes bit-packed into uint32 words in the lane-major tile layout
// of kernels/packing.py:pack_block_fp_subbyte, + float32 per-block scales
// by tile. in_padded: a multiple of tile = (32 / width) * 128.
// words: [out, in_padded / per_word]; scales: [n_tiles, out, tile / block].
void bfp_pack_subbyte(const float* w, int64_t out, int64_t in_padded,
                      int width, int exponent_width, int exponent_bias,
                      int block, uint32_t* words, float* scales,
                      int n_threads) {
  const BfpParams p = make_params(width, exponent_width, exponent_bias);
  const float zero_fill = compute_zero_fill(w, out, in_padded, block);
  const int per_word = 32 / width;
  const int kSlice = 128;
  const int tile = per_word * kSlice;
  const int64_t nt = in_padded / tile;
  const int spt = tile / block;  // scales a tile
  const int cmax = (1 << (width - 1)) - 1;
  const int64_t words_per_row = in_padded / per_word;  // nt * kSlice
  parallel_rows(out, n_threads, [&](int64_t lo, int64_t hi) {
    std::vector<int8_t> codes(in_padded);
    std::vector<float> row_scales(in_padded / block);
    for (int64_t r = lo; r < hi; ++r) {
      quantize_row(w + r * in_padded, in_padded, block, p, zero_fill,
                   codes.data(), row_scales.data());
      for (int64_t t = 0; t < nt; ++t) {
        std::memcpy(scales + (t * out + r) * spt, row_scales.data() + t * spt,
                    spt * sizeof(float));
      }
      // word g of tile t: sum over j of (code[t*tile + j*128 + g] + cmax) << (width*j)
      uint32_t* wr = words + r * words_per_row;
      for (int64_t t = 0; t < nt; ++t) {
        const int8_t* ct = codes.data() + t * tile;
        uint32_t* wt = wr + t * kSlice;
        for (int g = 0; g < kSlice; ++g) {
          uint32_t acc = 0;
          for (int j = 0; j < per_word; ++j) {
            acc |= static_cast<uint32_t>(static_cast<int>(ct[j * kSlice + g]) + cmax)
                   << (width * j);
          }
          wt[g] = acc;
        }
      }
    }
  });
}

}  // extern "C"
