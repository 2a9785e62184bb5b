// One block's share of C = flush(A · B) for int8 A and B with exact int32
// sums: the single-stage tile loop of conv_im2col_i8 (conv_im2col.cu). The
// f32 kernels run the two-stage cp.async loop of tile_gemm_async.cuh,
// gemm_i8 and unit_conv_gemms_i8 the int8 tensor cores (tile_mma_i8.cuh);
// every loop uses the flush policies, the chunk depth kBK and the tile
// dispatch defined here.
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
// Operand types. The int8 operands (conv_im2col_i8's gathered Toeplitz
// entries and its weights) are widened to int when they are staged
// (shared memory holds 4-byte words), multiplied with IMAD and summed in
// int32: exact, so the K order does not matter. The caller's K bound
// (K · 127² < 2^31) keeps the sum in range.
//
// Where A comes from is the caller's policy: ALoader::begin_chunk(gk) sets
// the A column this thread loads for the chunk (gk = k0 + tid % 16), and
// ALoader::load(r) returns A[m0 + tid / 16 + 16 r][gk] widened to
// ALoader::value_type, or 0 out of range; conv_im2col.cu gathers A's
// entries (the Toeplitz matrix) straight from the NHWC input. Where C goes
// is the Flush policy: flush(gm, gn, acc) is called once per in-range
// output element after the K loop.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBK = 16;        // depth of one shared-memory K chunk
constexpr int kInt8Max = 127;  // symmetric int8: [-127, 127]

template <int BM, int BN, class ALoader, class BT, class Flush>
__device__ __forceinline__ void tile_gemm_flush(ALoader& lda,
                                                const BT* __restrict__ b,
                                                const Flush& flush, int m,
                                                int n, int k) {
  using S = typename ALoader::value_type;  // staged and summed type
  constexpr int TM = BM / 16;              // rows of the micro-tile
  constexpr int TN = BN / 16;              // cols of the micro-tile
  constexpr int RB = BN * kBK / kThreads;  // B entries a thread stages
  static_assert(BM % 16 == 0 && BN % 16 == 0, "tile edges are 16-multiples");
  static_assert((BN * kBK) % kThreads == 0, "B chunk splits evenly");

  __shared__ S As[kBK][BM + 4];
  __shared__ S Bs[kBK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  S acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = S(0);

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
      Bs[kk][nn] = (gk < k && gn < n) ? static_cast<S>(b[(size_t)gk * n + gn])
                                      : S(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      S av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }

  // The single flush of C, in registers.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= n) continue;
      flush(gm, gn, acc[i][j]);
    }
  }
}

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
};

// The raw int32 sum into C (m, n): kn2row's phase-1 partials.
struct RawI32Flush {
  int* __restrict__ c;
  int n;

  __device__ __forceinline__ void operator()(int gm, int gn, int acc) const {
    c[(size_t)gm * n + gn] = acc;
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
