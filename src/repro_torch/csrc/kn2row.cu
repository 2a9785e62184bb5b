// kn2row convolution (§2.1.2) in IEEE f32 and in int8: the K1·K2 unit-conv
// GEMMs of phase 1 and the pad-and-accumulate of phase 2 with the fused
// flush.
//
// Replaces, in src/repro/kernels/kn2row/kn2row.py:
//   unit_conv_gemms  -> unit_conv_gemms_f32, and unit_conv_gemms_i8 for its
//                       int8 path (exact int32 partials)
//   pad_accumulate   -> pad_accumulate_f32, and pad_accumulate_i32 for its
//                       int8 path (int32 sum, then dequant → bias → ReLU →
//                       optional requant)
// On the main path (full-width Inception-v4) they run its 16 kn2row layers:
// the 3x3 stride-2 VALID reductions (stem/c4, stem/c5, redA/b2), the 1x1
// redA/b3a, and the 1x3 / 3x1 SAME convs of the Inception-C blocks, each
// as one launch of each kernel per layer per forward, with the batch folded
// into the GEMM's M.
//
// Layouts: x2d (M, Cin) with M = B·H·W (the NHWC map, flattened); w (G,
// Cin, Cout) with G = K1·K2 and g = k1·K2 + k2; p (G, B, H, W, Cout), the
// unit-conv products at full input resolution, as the reference computes
// them; out (B, O1, O2, Cout).
//
// What bounds them on an H100. Phase 1 is arithmetic: per row of x2d it
// does 2·G·Cin·Cout FLOP for 4·(Cin + G·Cout) bytes read and written, 30
// (stem/c4) to 170 (redA/b2) FLOP per byte on Inception-v4's layers, above
// the ~20 where 67 TFLOP/s of non-tensor-core f32 meets 3.35 TB/s. At stride 2
// it multiplies at full input resolution, as the reference does: ~4x the
// direct conv's multiplies on stem/c4. Phase 2 is bytes: G adds per output
// value, and it reads G of p's values per output (a quarter of p at stride
// 2) and writes the output once.
//
// What the design does about it. Phase 1 runs the f32 mainloop of gemm_f32
// (tile_gemm_async.cuh: two-stage cp.async buffer of 16-deep K chunks, one
// barrier per chunk, float4 shared-memory reads) with one grid layer per g,
// but A's pointer is the same for every g: the reference's "X block index
// map ignores g". Every g reads the same x2d, so its tiles are served from
// L2 when blocks of several g run together. It has no epilogue (bias and
// ReLU come after the sum), and ragged M/N/K edges are zero-filled: nothing
// is padded on the host (the reference pads x2d and w to its blocks). A
// grid with fewer blocks than the card has SMs (the Inception-C layers: 24
// blocks at batch 8, 3 at batch 1) splits K into S slices, grid z = g·S +
// s, each slice's raw partial in the workspace (S, G·M, Cout); then
// unit_conv_gemms_f32_reduce_kernel, launched by the same entry point on
// the same stream, sums the slices in the order s = 0, 1, … into p: the
// same bits on every call. Phase 2 runs one thread per output element (b,
// y, x, c), channel fastest, so each warp's load of one p_g row and its
// store are 32 consecutive floats. The TPU kernel walks a grid over the
// offsets with the output resident in VMEM; here the loop over g = 0 …
// G-1 runs inside the thread with the sum in a register, and
// bias and ReLU are applied there before the single store. The reference
// zero-pads p on the host first (another write of p, ~620 MB at stem/c4
// and batch 8); here a row or column outside [0, H) x [0, W) of the
// thread's own image is a predicate that adds nothing, so p is never
// padded and a SAME pad never reads the neighbouring image of the batch.
//
// The int8 forms. Phase 1 runs on the int8 tensor cores through
// tile_mma_i8.cuh (mma.sync m16n8k32 s8, cp.async double buffer), with
// blockIdx.z = g and one A for every g as in f32: it reads int8 x2d and w
// (a quarter of the f32 bytes), sums in int32 and writes exact int32 p
// with the f32 layout (p is as large as in f32: 597 MB at stem/c4, batch
// 8, so the store of p bounds it); no scale is applied there, since the
// per-channel scale is the same for every offset. Phase 2 sums the int32
// offsets in a register (exact, so any order gives the same sum) and
// applies the quantized flush of tile_gemm.cuh before its single store,
// f32 or int8. On the gated Inception-v4 path they run its 15 int8 kn2row
// layers.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_gemm.cuh"
#include "tile_gemm_async.cuh"
#include "tile_mma_i8.cuh"

namespace {

constexpr int kAccThreads = 256;

// Offset g = blockIdx.z / splits, K slice s = blockIdx.z % splits: the
// whole product into p[g] when splits is 1, else the slice's raw partial
// into work[s] (G·M, N) at rows g·M.
template <int BM, int BN>
__global__ void __launch_bounds__(repro::kThreads)
    unit_conv_gemms_f32_kernel(const float* __restrict__ x,
                               const float* __restrict__ w,
                               float* __restrict__ p, float* __restrict__ work,
                               int m, int n, int k, int splits, int vec) {
  const size_t g = blockIdx.z / splits;
  const int s = blockIdx.z % splits;
  // The same A (x2d) for every g; w offset by g.
  const float* wg = w + g * k * n;
  const repro::DenseA src{x, m, k};
  if (splits == 1) {
    repro::tile_gemm_async<BM, BN>(
        src, wg, repro::F32Flush{nullptr, p + g * m * n, n, 0}, m, n, 0, k,
        vec);
    return;
  }
  const size_t groups = gridDim.z / splits;
  const int depth = repro::slice_depth(k, splits);
  repro::tile_gemm_async<BM, BN>(
      src, wg, repro::RawF32Flush{work + (s * groups + g) * m * n, n}, m, n,
      s * depth, min(k, (s + 1) * depth), vec);
}

__global__ void __launch_bounds__(repro::kReduceThreads)
    unit_conv_gemms_f32_reduce_kernel(const float* __restrict__ work,
                                      float* __restrict__ p, long long total,
                                      int n, int splits) {
  repro::reduce_slices(work, nullptr, p, total, n, splits, 0);
}

template <int BM, int BN>
__global__ void __launch_bounds__(repro::kThreads)
    unit_conv_gemms_i8_kernel(const int8_t* __restrict__ x,
                              const int8_t* __restrict__ w,
                              int* __restrict__ p, int m, int n, int k,
                              int vec) {
  const size_t g = blockIdx.z;
  // The same A (x2d) for every g; w and p offset by g.
  repro::tile_mma_i8_flush<BM, BN>(x, w + g * k * n,
                                   repro::RawI32Flush{p + g * m * n, n}, m,
                                   n, k, vec);
}

// One output element (b, y, x, c) per thread: the sum over the K1·K2
// offsets of p's in-map values, in the order g = 0 … G-1. Returns false
// for a thread past the end.
template <class T>
__device__ __forceinline__ bool accumulate(const T* __restrict__ p, int batch,
                                           int h, int w, int c, int k1,
                                           int k2, int o1, int o2, int stride,
                                           int pad_top, int pad_left,
                                           long long* index, int* channel,
                                           T* sum) {
  const long long total = (long long)batch * o1 * o2 * c;
  const long long i = (long long)blockIdx.x * kAccThreads + threadIdx.x;
  if (i >= total) return false;
  const int ch = (int)(i % c);
  long long rest = i / c;
  const int ox = (int)(rest % o2);
  rest /= o2;
  const int oy = (int)(rest % o1);
  const int b = (int)(rest / o1);

  const size_t plane = (size_t)batch * h * w * c;  // one offset's p_g
  const T* __restrict__ img = p + (size_t)b * h * w * c + ch;
  T acc = T(0);
  for (int dk1 = 0; dk1 < k1; ++dk1) {
    const int row = stride * oy + dk1 - pad_top;
    if (row < 0 || row >= h) continue;
    for (int dk2 = 0; dk2 < k2; ++dk2) {
      const int col = stride * ox + dk2 - pad_left;
      if (col < 0 || col >= w) continue;
      acc += img[(size_t)(dk1 * k2 + dk2) * plane +
                 ((size_t)row * w + col) * c];
    }
  }
  *index = i;
  *channel = ch;
  *sum = acc;
  return true;
}

__global__ void __launch_bounds__(kAccThreads)
    pad_accumulate_f32_kernel(const float* __restrict__ p,
                              const float* __restrict__ bias,
                              float* __restrict__ out, int batch, int h,
                              int w, int c, int k1, int k2, int o1, int o2,
                              int stride, int pad_top, int pad_left,
                              int relu) {
  long long i;
  int ch;
  float acc;
  if (!accumulate(p, batch, h, w, c, k1, k2, o1, o2, stride, pad_top,
                  pad_left, &i, &ch, &acc))
    return;
  if (bias != nullptr) acc += bias[ch];
  if (relu) acc = acc > 0.f ? acc : 0.f;
  out[i] = acc;
}

__global__ void __launch_bounds__(kAccThreads)
    pad_accumulate_i32_kernel(const int* __restrict__ p,
                              repro::QuantFlush flush, int batch, int h,
                              int w, int c, int k1, int k2, int o1, int o2,
                              int stride, int pad_top, int pad_left) {
  long long i;
  int ch;
  int acc;
  if (!accumulate(p, batch, h, w, c, k1, k2, o1, o2, stride, pad_top,
                  pad_left, &i, &ch, &acc))
    return;
  // The output viewed as (total / c, c): row i / c, channel ch.
  flush((int)(i / c), ch, acc);
}

}  // namespace

// p (groups, m, n) = x (m, k) · w[g] (k, n) for g < groups: one A shared by
// every g, no epilogue; all f32, contiguous, on the current device, p
// 16-byte aligned. (tile_m, tile_n) must be an instantiated tile: 64 or 128
// each. K is cut into `splits` slices (slice_depth); with splits > 1, work
// is the f32 workspace (splits, groups·m, n) and a second kernel on the
// same stream sums the slices in order into p. vec: n % 4 == 0 and w
// 16-byte aligned. Returns cudaGetLastError().
extern "C" int unit_conv_gemms_f32(const void* x, const void* w, void* p,
                                   void* work, int groups, int m, int n,
                                   int k, int tile_m, int tile_n, int splits,
                                   int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_TILE(unit_conv_gemms_f32_kernel, tile_m, tile_n, m, n,
                      groups * splits, st, static_cast<const float*>(x),
                      static_cast<const float*>(w), static_cast<float*>(p),
                      static_cast<float*>(work), m, n, k, splits, vec);
  const int err = (int)cudaGetLastError();
  if (err != 0 || splits == 1) return err;
  const long long total = (long long)groups * m * n;
  unit_conv_gemms_f32_reduce_kernel<<<repro::reduce_blocks(total, n),
                                      repro::kReduceThreads, 0, st>>>(
      static_cast<const float*>(work), static_cast<float*>(p), total, n,
      splits);
  return (int)cudaGetLastError();
}

// p (groups, m, n) = x (m, k) · w[g] (k, n) for g < groups with x and w
// int8 and p the exact int32 sums: one A shared by every g, no epilogue;
// all contiguous, on the current device; the caller keeps k · 127² < 2^31.
// (tile_m, tile_n) must be an instantiated tile: 64 or 128 each. Returns
// cudaGetLastError().
extern "C" int unit_conv_gemms_i8(const void* x, const void* w, void* p,
                                  int groups, int m, int n, int k,
                                  int tile_m, int tile_n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_TILE(unit_conv_gemms_i8_kernel, tile_m, tile_n, m, n,
                      groups, s, static_cast<const int8_t*>(x),
                      static_cast<const int8_t*>(w), static_cast<int*>(p), m,
                      n, k, (int)repro::i8_vector_path(x, w, n, k));
  return (int)cudaGetLastError();
}

// out (batch, o1, o2, c) = epilogue(Σ_g p[g, b, S·y + k1 - pad_top,
// S·x + k2 - pad_left, c] [+ bias (c)]) over g = k1·K2 + k2 < K1·K2, rows
// and columns outside the (h, w) map counting as 0; p (K1·K2, batch, h, w,
// c), all f32, contiguous, on the current device. bias may be NULL.
// Returns cudaGetLastError().
extern "C" int pad_accumulate_f32(const void* p, const void* bias, void* out,
                                  int batch, int h, int w, int c, int k1,
                                  int k2, int o1, int o2, int stride,
                                  int pad_top, int pad_left, int relu,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)batch * o1 * o2 * c;
  const unsigned blocks = (unsigned)((total + kAccThreads - 1) / kAccThreads);
  pad_accumulate_f32_kernel<<<blocks, kAccThreads, 0, s>>>(
      static_cast<const float*>(p), static_cast<const float*>(bias),
      static_cast<float*>(out), batch, h, w, c, k1, k2, o1, o2, stride,
      pad_top, pad_left, relu);
  return (int)cudaGetLastError();
}

// out (batch, o1, o2, c) = flush(Σ_g p[g, b, S·y + k1 - pad_top,
// S·x + k2 - pad_left, c]) over g = k1·K2 + k2 < K1·K2 for int32 p
// (K1·K2, batch, h, w, c), the sum in int32, rows and columns outside the
// (h, w) map counting as 0; the flush is v = (float)sum · scale[c]
// [+ bias[c]] [ReLU], stored as f32, or, when requant is nonzero, as int8:
// clamp(round-half-even(v / out_scale), ±127). scale (c) f32; bias may be
// NULL; all contiguous, on the current device. Returns cudaGetLastError().
extern "C" int pad_accumulate_i32(const void* p, const void* scale,
                                  const void* bias, void* out, int batch,
                                  int h, int w, int c, int k1, int k2, int o1,
                                  int o2, int stride, int pad_top,
                                  int pad_left, int relu, int requant,
                                  float out_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)batch * o1 * o2 * c;
  const unsigned blocks = (unsigned)((total + kAccThreads - 1) / kAccThreads);
  const repro::QuantFlush flush{
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      requant ? nullptr : static_cast<float*>(out),
      requant ? static_cast<int8_t*>(out) : nullptr, out_scale, c, relu};
  pad_accumulate_i32_kernel<<<blocks, kAccThreads, 0, s>>>(
      static_cast<const int*>(p), flush, batch, h, w, c, k1, k2, o1, o2,
      stride, pad_top, pad_left);
  return (int)cudaGetLastError();
}
