// One block's share of C = epilogue(A · B + bias) in IEEE f32 — the tile
// loop the GEMM kernels share (gemm.cu's dense and batched GEMMs,
// conv_im2col.cu, kn2row.cu's unit-conv GEMMs).
//
// A block of 256 threads (16 x 16) owns a BM x BN tile of C. K is walked in
// 16-deep chunks staged through shared memory: A's chunk is stored
// transposed (As[k][m]) so that the inner product reads one broadcast A
// value per thread row and 16 consecutive B values per thread column.
// Each thread accumulates a (BM/16) x (BN/16) register micro-tile whose
// rows and columns are strided by 16, so the final store of C is
// coalesced along N. Ragged M, N and K edges are masked here (loads of 0,
// stores skipped), so callers never pad operands.
//
// Where A comes from is the caller's policy: ALoader::begin_chunk(gk) sets
// the A column this thread loads for the chunk (gk = k0 + tid % 16), and
// ALoader::load(r) returns A[m0 + tid / 16 + 16 r][gk], or 0 out of range.
// gemm.cu reads a dense row-major A; conv_im2col.cu gathers A's entries
// (the Toeplitz matrix) straight from the NHWC input.
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBK = 16;        // depth of one shared-memory K chunk

template <int BM, int BN, class ALoader>
__device__ __forceinline__ void tile_gemm(ALoader& lda,
                                          const float* __restrict__ b,
                                          const float* __restrict__ bias,
                                          float* __restrict__ c, int m, int n,
                                          int k, int relu) {
  constexpr int TM = BM / 16;                // rows of the micro-tile
  constexpr int TN = BN / 16;                // cols of the micro-tile
  constexpr int RB = BN * kBK / kThreads;    // B entries a thread stages
  static_assert(BM % 16 == 0 && BN % 16 == 0, "tile edges are 16-multiples");
  static_assert((BN * kBK) % kThreads == 0, "B chunk splits evenly");

  __shared__ float As[kBK][BM + 4];
  __shared__ float Bs[kBK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    lda.begin_chunk(k0 + tx);
#pragma unroll
    for (int r = 0; r < TM; ++r) As[tx][ty + 16 * r] = lda.load(r);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int i = tid + r * kThreads;
      const int kk = i / BN;
      const int nn = i % BN;
      const int gk = k0 + kk;
      const int gn = n0 + nn;
      Bs[kk][nn] = (gk < k && gn < n) ? b[(size_t)gk * n + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Fused epilogue in registers, then the single store of C.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= n) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[gn];
      if (relu) v = v > 0.f ? v : 0.f;
      c[(size_t)gm * n + gn] = v;
    }
  }
}

// Dense row-major A (m, k): the ALoader of gemm.cu's GEMMs and kn2row.cu's
// unit-conv GEMMs.
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
