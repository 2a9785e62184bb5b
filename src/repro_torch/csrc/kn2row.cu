// kn2row convolution (§2.1.2) in IEEE f32: the K1·K2 unit-conv GEMMs of
// phase 1 and the pad-and-accumulate of phase 2 with the fused bias/ReLU
// flush.
//
// Replaces, in src/repro/kernels/kn2row/kn2row.py:
//   unit_conv_gemms  -> unit_conv_gemms_f32
//   pad_accumulate   -> pad_accumulate_f32
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
// What the design does about it. Phase 1 reuses tile_gemm.cuh with
// blockIdx.z = g, as the batched GEMM does, but A's pointer is the same
// for every g: the reference's "X block index map ignores g". Every g
// reads the same x2d, so its tiles are served from L2 when blocks of
// several g run together. It has no epilogue (bias and ReLU come after the
// sum), and ragged M/N/K edges are masked: nothing is padded on the host
// (the reference pads x2d and w to its blocks). Phase 2 runs one thread
// per output element (b, y, x, c), channel fastest, so each warp's load of
// one p_g row and its store are 32 consecutive floats. The TPU kernel walks
// a grid over the offsets with the output resident in VMEM; here the loop
// over g = 0 … G-1 runs inside the thread with the sum in a register, and
// bias and ReLU are applied there before the single store. The reference
// zero-pads p on the host first (another write of p, ~620 MB at stem/c4
// and batch 8); here a row or column outside [0, H) x [0, W) of the
// thread's own image is a predicate that adds nothing, so p is never
// padded and a SAME pad never reads the neighbouring image of the batch.
#include <cuda_runtime.h>

#include "tile_gemm.cuh"

namespace {

constexpr int kAccThreads = 256;

template <int BM, int BN>
__global__ void __launch_bounds__(repro::kThreads)
    unit_conv_gemms_f32_kernel(const float* __restrict__ x,
                               const float* __restrict__ w,
                               float* __restrict__ p, int m, int n, int k) {
  const size_t g = blockIdx.z;
  // The same A (x2d) for every g.
  repro::DenseA lda(x, m, k, blockIdx.y * BM + threadIdx.x / 16);
  repro::tile_gemm<BM, BN>(lda, w + g * k * n, nullptr, p + g * m * n, m, n,
                           k, 0);
}

__global__ void __launch_bounds__(kAccThreads)
    pad_accumulate_f32_kernel(const float* __restrict__ p,
                              const float* __restrict__ bias,
                              float* __restrict__ out, int batch, int h,
                              int w, int c, int k1, int k2, int o1, int o2,
                              int stride, int pad_top, int pad_left,
                              int relu) {
  const long long total = (long long)batch * o1 * o2 * c;
  const long long i = (long long)blockIdx.x * kAccThreads + threadIdx.x;
  if (i >= total) return;
  const int ch = (int)(i % c);
  long long rest = i / c;
  const int ox = (int)(rest % o2);
  rest /= o2;
  const int oy = (int)(rest % o1);
  const int b = (int)(rest / o1);

  const size_t plane = (size_t)batch * h * w * c;  // one offset's p_g
  const float* __restrict__ img = p + (size_t)b * h * w * c + ch;
  float acc = 0.f;
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
  if (bias != nullptr) acc += bias[ch];
  if (relu) acc = acc > 0.f ? acc : 0.f;
  out[i] = acc;
}

}  // namespace

// p (groups, m, n) = x (m, k) · w[g] (k, n) for g < groups: one A shared by
// every g, no epilogue; all f32, contiguous, on the current device.
// (tile_m, tile_n) must be an instantiated tile: 64 or 128 each. Returns
// cudaGetLastError().
extern "C" int unit_conv_gemms_f32(const void* x, const void* w, void* p,
                                   int groups, int m, int n, int k,
                                   int tile_m, int tile_n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_TILE(unit_conv_gemms_f32_kernel, tile_m, tile_n, m, n,
                      groups, s, static_cast<const float*>(x),
                      static_cast<const float*>(w), static_cast<float*>(p),
                      m, n, k);
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
