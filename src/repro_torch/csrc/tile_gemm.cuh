// What every tile loop of the kernels shares: the block size kThreads, the
// f32 loop's chunk depth kBK, the int8 range, the flush policies and the
// tile dispatch. The loops themselves live in tile_gemm_async.cuh (every f32
// K loop: IEEE fmaf through two cp.async stages), tile_mma_i8.cuh (every
// int8 K loop: mma.sync on the int8 tensor cores, exact int32 sums) and
// tile_mma_bf16.cuh (every bf16 K loop: mma.sync on the bf16 tensor cores,
// f32 sums).
//
// A flush policy takes the finished sum of one output element after the K
// loop: flush(gm, gn, acc). The int8 policies also take the adjacent pair
// (gm, gn), (gm, gn + 1) that an mma.sync fragment holds in one thread,
// flush.pair(gm, gn, acc0, acc1), for gn and n even: one 8-byte f32, 2-byte
// int8 or 8-byte int32 store, each value flushed exactly as operator() would
// flush it, so a pair store changes no output bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kThreads = 256;  // 16 x 16 (f32), 8 warps (int8)
constexpr int kBK = 16;        // depth of one K chunk of the f32 loop
constexpr int kInt8Max = 127;  // symmetric int8: [-127, 127]

// f32 flush: bias and ReLU, then the store.
struct F32Flush {
  const float* __restrict__ bias;
  float* __restrict__ c;
  int n, relu;

  __device__ __forceinline__ void operator()(int gm, int gn, float v) const {
    if (bias != nullptr) v += bias[gn];
    if (relu) v = v > 0.f ? v : 0.f;
    c[(size_t)gm * n + gn] = v;
  }
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Two adjacent outputs in one 8-byte (f32) or 4-byte (bf16) store.
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0,
                                           float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// The flush of an f32 sum into C (m, n) of Out (f32 or bf16), as the
// reference's kernels flush their f32 accumulator: + bias[n] widened to
// f32 (a Bias array: f32 or bf16, or none), ReLU, then one
// round-to-nearest-even store in Out (o_ref[...] = acc.astype(dtype)).
// The bf16 kernels flush through it, and the f32 loop with a bf16 C
// (out_dtype=bf16); an f32 C of the f32 loop keeps F32Flush.
template <class Bias, class Out>
struct CastFlush {
  const Bias* __restrict__ bias;
  Out* __restrict__ c;
  int n, relu;

  __device__ __forceinline__ float value(int gn, float v) const {
    if (bias != nullptr) v = __fadd_rn(v, widen(bias[gn]));
    if (relu) v = v > 0.f ? v : 0.f;
    return v;
  }

  __device__ __forceinline__ void operator()(int gm, int gn, float v) const {
    store_as(c + (size_t)gm * n + gn, value(gn, v));
  }

  // gn and n even: the pair is aligned to its two elements in the
  // outputs the wrappers allocate.
  __device__ __forceinline__ void pair(int gm, int gn, float v0,
                                       float v1) const {
    store_pair(c + (size_t)gm * n + gn, value(gn, v0), value(gn + 1, v1));
  }
};

// The quantized flush of an exact int32 sum, as the reference's
// apply_epilogue orders it: v = (float)acc · scale[n], + bias[n], ReLU;
// then either v stored as f32, or q = round-half-even(v / out_scale)
// clamped to ±127 and stored as int8. Each step is one IEEE-rounded
// operation (no FMA contraction, no reciprocal), as torch computes it.
__device__ __forceinline__ float dequant_epilogue(int acc, float scale,
                                                  const float* bias, int gn,
                                                  int relu) {
  float v = __fmul_rn(__int2float_rn(acc), scale);
  if (bias != nullptr) v = __fadd_rn(v, bias[gn]);
  if (relu) v = v > 0.f ? v : 0.f;
  return v;
}

__device__ __forceinline__ int8_t requantize(float v, float out_scale) {
  int q = __float2int_rn(__fdiv_rn(v, out_scale));
  q = q < -kInt8Max ? -kInt8Max : (q > kInt8Max ? kInt8Max : q);
  return static_cast<int8_t>(q);
}

// Quantized flush into C (m, n): f32 when out_q is null, else int8.
struct QuantFlush {
  const float* __restrict__ scale;
  const float* __restrict__ bias;
  float* __restrict__ out_f;
  int8_t* __restrict__ out_q;
  float out_scale;
  int n, relu;

  __device__ __forceinline__ void operator()(int gm, int gn, int acc) const {
    const float v = dequant_epilogue(acc, scale[gn], bias, gn, relu);
    const size_t o = (size_t)gm * n + gn;
    if (out_q != nullptr)
      out_q[o] = requantize(v, out_scale);
    else
      out_f[o] = v;
  }

  // gn and n even, so the f32 pair is 8-byte and the int8 pair 2-byte
  // aligned in the outputs the wrappers allocate.
  __device__ __forceinline__ void pair(int gm, int gn, int acc0,
                                       int acc1) const {
    const float v0 = dequant_epilogue(acc0, scale[gn], bias, gn, relu);
    const float v1 = dequant_epilogue(acc1, scale[gn + 1], bias, gn + 1, relu);
    const size_t o = (size_t)gm * n + gn;
    if (out_q != nullptr)
      *reinterpret_cast<char2*>(out_q + o) =
          make_char2(requantize(v0, out_scale), requantize(v1, out_scale));
    else
      *reinterpret_cast<float2*>(out_f + o) = make_float2(v0, v1);
  }
};

// The raw int32 sum into C (m, n): kn2row's phase-1 partials.
struct RawI32Flush {
  int* __restrict__ c;
  int n;

  __device__ __forceinline__ void operator()(int gm, int gn, int acc) const {
    c[(size_t)gm * n + gn] = acc;
  }

  __device__ __forceinline__ void pair(int gm, int gn, int acc0,
                                       int acc1) const {
    *reinterpret_cast<int2*>(c + (size_t)gm * n + gn) = make_int2(acc0, acc1);
  }
};

// Launch `kernel<BM, BN>` for one of the instantiated tiles on a grid of
// (GRID_N / TILE_N) x (GRID_M / TILE_M) x GRID_G blocks (blockIdx.z picks
// one of GRID_G independent problems). Returns cudaErrorInvalidValue for a
// tile that is not instantiated.
#define REPRO_DISPATCH_TILE(KERNEL, TILE_M, TILE_N, GRID_M, GRID_N, GRID_G, \
                            STREAM, ...)                                    \
  do {                                                                      \
    const dim3 grid_(((GRID_N) + (TILE_N)-1) / (TILE_N),                    \
                     ((GRID_M) + (TILE_M)-1) / (TILE_M), (GRID_G));         \
    if ((TILE_M) == 128 && (TILE_N) == 128)                                 \
      KERNEL<128, 128><<<grid_, repro::kThreads, 0, STREAM>>>(__VA_ARGS__); \
    else if ((TILE_M) == 128 && (TILE_N) == 64)                             \
      KERNEL<128, 64><<<grid_, repro::kThreads, 0, STREAM>>>(__VA_ARGS__);  \
    else if ((TILE_M) == 64 && (TILE_N) == 128)                             \
      KERNEL<64, 128><<<grid_, repro::kThreads, 0, STREAM>>>(__VA_ARGS__);  \
    else if ((TILE_M) == 64 && (TILE_N) == 64)                              \
      KERNEL<64, 64><<<grid_, repro::kThreads, 0, STREAM>>>(__VA_ARGS__);   \
    else                                                                    \
      return (int)cudaErrorInvalidValue;                                    \
  } while (0)

}  // namespace repro
