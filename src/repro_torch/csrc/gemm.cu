// Dataflow-bound tiled GEMM with the fused bias/ReLU flush, IEEE f32.
//
// Replaces: src/repro/kernels/gemm/gemm.py::gemm_pallas (body _gemm_kernel),
// the TPU Computing Unit on the MXU. On the main path it runs every conv
// whose input edge already carries its Toeplitz matrix
// (kernels/gemm/ops.py::toeplitz_gemm), with the batch folded into M so
// one launch covers a layer for the whole batch.
//
// What bounds it on an H100: arithmetic, for most main-path layers. The
// card's 67 TFLOP/s of non-tensor-core f32 meets its 3.35 TB/s of HBM at
// ~20 FLOP per byte; conv2 at batch 8 (M = 25088, K = 576, N = 192) does
// ~72 FLOP per byte of operands, and only layers with a narrow N (32, 48,
// 64 channels on 7x7 maps) fall below the ridge. The kernel computes in
// IEEE f32 FMA (not TF32) so it matches the reference at 1e-4, which rules
// out the tensor cores.
//
// What the design does about it: a 128 x 128 (or 64-edge) output tile per
// 256-thread block with an 8 x 8 register micro-tile, so each thread does
// 64 FMAs per 16 shared-memory loads; K streams in 16-deep chunks through
// shared memory (the TPU kernel's K grid axis and its VMEM accumulator
// become a loop inside the block and registers); bias and ReLU are applied
// in registers before the single store; ragged M/N/K edges are masked in
// the kernel instead of padding operands on the host. No double buffering,
// cp.async or wgmma yet: that is later work.
#include <cuda_runtime.h>

#include "tile_gemm.cuh"

namespace {

// Dense row-major A (m, k).
struct DenseA {
  const float* __restrict__ a;
  int m, k, row0, gk;

  __device__ DenseA(const float* a_, int m_, int k_, int row0_)
      : a(a_), m(m_), k(k_), row0(row0_), gk(0) {}

  __device__ __forceinline__ void begin_chunk(int gk_) { gk = gk_; }

  __device__ __forceinline__ float load(int r) const {
    const int gm = row0 + 16 * r;
    return (gm < m && gk < k) ? a[(size_t)gm * k + gk] : 0.f;
  }
};

template <int BM, int BN>
__global__ void __launch_bounds__(repro::kThreads)
    gemm_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ bias, float* __restrict__ c,
                    int m, int n, int k, int relu) {
  DenseA lda(a, m, k, blockIdx.y * BM + threadIdx.x / 16);
  repro::tile_gemm<BM, BN>(lda, b, bias, c, m, n, k, relu);
}

}  // namespace

// C (m, n) = epilogue(A (m, k) · B (k, n) [+ bias (n)]); all f32,
// contiguous, on the current device. bias may be NULL. (tile_m, tile_n)
// must be an instantiated tile: 64 or 128 each. Returns cudaGetLastError().
extern "C" int gemm_f32(const void* a, const void* b, const void* bias,
                        void* c, int m, int n, int k, int tile_m, int tile_n,
                        int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_TILE(gemm_f32_kernel, tile_m, tile_n, m, n, s,
                      static_cast<const float*>(a),
                      static_cast<const float*>(b),
                      static_cast<const float*>(bias), static_cast<float*>(c),
                      m, n, k, relu);
  return (int)cudaGetLastError();
}
