// One block's BM x BN tile of C = flush(A[:, k0:k1] · B[k0:k1, :]) for
// [k0, k1) = [k_begin, k_end), f32 A (m, k) from the caller's A source and
// dense row-major f32 B (k, n), summed with IEEE fmaf: the mainloop of
// gemm.cu's gemm_f32 and batched_gemm_f32, kn2row.cu's unit_conv_gemms_f32
// (dense A) and conv_im2col.cu's conv_im2col_f32 (A gathered from an NHWC
// map), and the fixed-order reduce of their K slices.
//
// Threads. 256 threads (16 x 16, tx = tid % 16, ty = tid / 16) each own a
// (BM/16) x (BN/16) register micro-tile (8 x 8 at 128 x 128) in groups of
// four: rows 64 i + 4 ty + {0..3} and columns 64 j + 4 tx + {0..3}, so the
// inner product reads A and B from shared memory as float4 (4 LDS.128 for
// 64 FMAs at 128 x 128) and the flush stores four columns at once. No TF32
// and no tensor cores: fmaf in K order holds the plain version at 1e-4.
//
// K chunks. [k_begin, k_end) is walked in kBK-deep chunks (16) through a
// two-stage shared-memory buffer: the cp.async copies of chunk c+1 are
// issued before the FMAs of chunk c, then cp.async.wait_group 0 and one
// __syncthreads per chunk (the barrier that publishes chunk c+1 also
// retires chunk c's buffer before it is refilled). At 128 x 128 the two
// stages take 33,280 bytes of static shared memory.
//
// A is read transposed, As[k][m], and cp.async cannot transpose, so A goes
// in as one 4-byte cp.async per element: a warp copies 8 consecutive k of 4
// consecutive rows, and the rows of As are padded from BM to BM + 4 floats,
// so those 32 stores fall in 32 distinct banks and every row still starts
// on 16 bytes for the float4 reads. (The other layout, As[m][k] by 16-byte
// copies, would make the inner product read A one float at a time: 8
// LDS.32 for 64 FMAs instead of 2 LDS.128.) Each thread copies A rows
// m0 + row + 32 i (i < BM / 32, row = tid / 8) at chunk columns
// k0 + col + 8 j (j < 2, col = tid % 8). Where those elements come from
// is the A source's policy (DenseA below; conv_im2col.cu's NHWC gather):
//   ASrc::Rows<BM / 32> rows(src, m0, row, col)  once per block: the
//                                    thread's row state;
//   rows.begin_chunk(k0, k_end)      once per chunk, before its copies:
//                                    the column state;
//   rows.in(i, j, k0, k_end)         whether element (i, j) is in A and in
//                                    the K slice;
//   rows.at(i, j, k0)                its address, copied only when in;
//   rows.a                           a valid address, the source of the
//                                    4-byte zero-fill of an element out
//                                    of range.
// B is (k, n) with n contiguous: 16-byte cp.async when the entry point
// found n % 4 == 0 and B 16-byte aligned (vec), else 4-byte copies.
// Ragged M, K and N edges are zero-filled through cp.async's src-size
// operand, so nothing past an operand's end is read.
//
// Split K. A caller whose grid has fewer blocks than the card has SMs runs
// S slices of K (kernels/gemm/gemm.py::split_k chooses S): slice s covers
// [s · depth, min((s+1) · depth, k)) with depth = slice_depth(k, S), whole
// chunks, and flushes its raw partial sum through RawF32Flush into a
// workspace (S, rows, n); reduce_slices then sums the S partials in the
// order s = 0, 1, … and applies bias and ReLU, so a shape gives the same
// bits on every call. With S = 1 the block flushes through F32Flush.
//
// The flush goes through the caller's policy: flush(gm, gn, v) per element,
// or flush4(flush, gm, gn, v) for four columns when n % 4 == 0, which needs
// C aligned to four elements (the wrappers allocate every output): F32Flush
// and RawF32Flush store f32, CastFlush<float, bf16> a bf16 C (out_dtype).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_gemm.cuh"
#include "tile_mma_i8.cuh"

namespace repro {

constexpr int kReduceThreads = 256;

// The depth of each K slice when k is split `splits` ways: whole chunks, so
// every slice starts on a chunk boundary and only the last may be ragged
// or short. kernels/gemm/gemm.py::k_slices mirrors it.
__host__ __device__ __forceinline__ int slice_depth(int k, int splits) {
  const int chunks = (k + kBK - 1) / kBK;
  return (chunks + splits - 1) / splits * kBK;
}

// The same for a loop of `chunk`-deep chunks (the bf16 wgmma loop's 64).
__host__ __device__ __forceinline__ int slice_depth(int k, int splits,
                                                    int chunk) {
  const int chunks = (k + chunk - 1) / chunk;
  return (chunks + splits - 1) / splits * chunk;
}

// The raw f32 partial sum of one K slice into its workspace slab (rows, n).
struct RawF32Flush {
  float* __restrict__ c;
  int n;

  __device__ __forceinline__ void operator()(int gm, int gn, float v) const {
    c[(size_t)gm * n + gn] = v;
  }
};

// Four consecutive outputs (gm, gn .. gn+3) in one 16-byte store, each
// value flushed as the policy's operator() flushes it.
__device__ __forceinline__ void flush4(const F32Flush& f, int gm, int gn,
                                       float4 v) {
  if (f.bias != nullptr) {
    v.x += f.bias[gn];
    v.y += f.bias[gn + 1];
    v.z += f.bias[gn + 2];
    v.w += f.bias[gn + 3];
  }
  if (f.relu) {
    v.x = v.x > 0.f ? v.x : 0.f;
    v.y = v.y > 0.f ? v.y : 0.f;
    v.z = v.z > 0.f ? v.z : 0.f;
    v.w = v.w > 0.f ? v.w : 0.f;
  }
  *reinterpret_cast<float4*>(f.c + (size_t)gm * f.n + gn) = v;
}

__device__ __forceinline__ void flush4(const RawF32Flush& f, int gm, int gn,
                                       float4 v) {
  *reinterpret_cast<float4*>(f.c + (size_t)gm * f.n + gn) = v;
}

// A bf16 C (out_dtype=bf16 of the f32 kernels, and the bf16 kernels'
// split-K reduce): bias widened, ReLU, four values rounded once, in one
// 8-byte store.
template <class Bias>
__device__ __forceinline__ void flush4(const CastFlush<Bias, __nv_bfloat16>& f,
                                       int gm, int gn, float4 v) {
  const __nv_bfloat162 lo =
      __floats2bfloat162_rn(f.value(gn, v.x), f.value(gn + 1, v.y));
  const __nv_bfloat162 hi =
      __floats2bfloat162_rn(f.value(gn + 2, v.z), f.value(gn + 3, v.w));
  *reinterpret_cast<uint2*>(f.c + (size_t)gm * f.n + gn) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

// The bf16 kernels' split-K reduce into an f32 C (out_dtype=f32): one
// 16-byte store.
__device__ __forceinline__ void flush4(
    const CastFlush<__nv_bfloat16, float>& f, int gm, int gn, float4 v) {
  *reinterpret_cast<float4*>(f.c + (size_t)gm * f.n + gn) =
      make_float4(f.value(gn, v.x), f.value(gn + 1, v.y),
                  f.value(gn + 2, v.z), f.value(gn + 3, v.w));
}

// 4 bytes global -> shared; zero when src_bytes is 0.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

// The two stages of A (transposed, rows padded) and B in shared memory.
template <int BM, int BN>
struct F32Stages {
  float a[2][kBK][BM + 4];
  float b[2][kBK][BN];
};

// One buffer per tile shape, whichever flush policies a kernel calls the
// loop with.
template <int BM, int BN>
__device__ __forceinline__ F32Stages<BM, BN>& f32_stages() {
  __shared__ __align__(16) F32Stages<BM, BN> sm;
  return sm;
}

// Dense row-major f32 A (m, k) as the loop's A source.
struct DenseA {
  const float* __restrict__ a;
  int m, k;

  template <int R>
  struct Rows {
    const float* __restrict__ a;       // A itself: the zero-fill's source
    const float* __restrict__ corner;  // &A[m0 + row][col]
    int k, rows_left, col;  // row m0 + row + 32 i is in A: 32 i < rows_left

    // rows_left as m - m0 - row: the association the f32 GEMMs were tuned
    // with (ptxas allocates registers differently for m - (m0 + row)).
    __device__ __forceinline__ Rows(const DenseA& s, int m0, int row,
                                    int col_)
        : a(s.a), corner(s.a + (size_t)(m0 + row) * s.k + col_), k(s.k),
          rows_left(s.m - m0 - row), col(col_) {}

    __device__ __forceinline__ void begin_chunk(int, int) {}

    __device__ __forceinline__ bool in(int i, int j, int k0,
                                       int k_end) const {
      return 32 * i < rows_left && k0 + col + 8 * j < k_end;
    }

    __device__ __forceinline__ const float* at(int i, int j, int k0) const {
      return corner + (size_t)(32 * i) * k + k0 + 8 * j;
    }
  };
};

template <int BM, int BN, bool kVec, class ASrc, class Flush>
__device__ __forceinline__ void tile_gemm_async_loop(
    F32Stages<BM, BN>& sm, const ASrc& asrc, const float* __restrict__ b,
    const Flush& flush, int m, int n, int k_begin, int k_end) {
  constexpr int TM = BM / 16;                 // rows of the micro-tile
  constexpr int TN = BN / 16;                 // cols of the micro-tile
  constexpr int RA = BM * kBK / kThreads;     // A copies a thread per chunk
  constexpr int RB = kVec ? BN * kBK / 4 / kThreads : BN * kBK / kThreads;
  static_assert(kThreads == 256, "16 x 16 threads");
  static_assert(kBK == 16, "A is copied as two 8-column halves");
  static_assert(BM % 64 == 0 && BN % 64 == 0, "tile edges are 64-multiples");

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // This thread's copies: A rows a_row + 32 i, columns a_col + 8 j (a warp
  // takes 8 consecutive k of 4 consecutive rows); B rows b_row + RS r,
  // columns b_col (+ 0..3 on the 16-byte path).
  constexpr int RS = kVec ? kThreads * 4 / BN : kThreads / BN;  // B row step
  const int a_row = tid / 8;
  const int a_col = tid % 8;
  const int b_row = kVec ? tid / (BN / 4) : tid / BN;
  const int b_col = kVec ? 4 * (tid % (BN / 4)) : tid % BN;
  typename ASrc::template Rows<BM / 32> a_rows(asrc, m0, a_row, a_col);
  const float* __restrict__ b_at = b + (size_t)b_row * n + n0 + b_col;
  const bool b_in_n = n0 + b_col < n;      // n % 4 == 0 on the vec path

  auto load = [&](int stage, int k0) {
    a_rows.begin_chunk(k0, k_end);
#pragma unroll
    for (int r = 0; r < RA; ++r) {
      const int i = r % (BM / 32);
      const int j = r / (BM / 32);
      const bool in = a_rows.in(i, j, k0, k_end);
      cp_async4(&sm.a[stage][a_col + 8 * j][a_row + 32 * i],
                in ? a_rows.at(i, j, k0) : a_rows.a, in ? 4 : 0);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int row = b_row + RS * r;
      const bool in = b_in_n && k0 + row < k_end;
      const float* src = in ? b_at + (size_t)(k0 + RS * r) * n : b;
      if constexpr (kVec)
        cp_async16(&sm.b[stage][row][b_col], src, in ? 16 : 0);
      else
        cp_async4(&sm.b[stage][row][b_col], src, in ? 4 : 0);
    }
    cp_async_commit();
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int chunks = (k_end - k_begin + kBK - 1) / kBK;
  if (chunks > 0) {
    load(0, k_begin);
    cp_async_wait_all();
    __syncthreads();
  }
  for (int c = 0; c < chunks; ++c) {
    const int cur = c & 1;
    if (c + 1 < chunks) load(cur ^ 1, k_begin + (c + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM / 4; ++i) {
        const float4 t =
            *reinterpret_cast<const float4*>(&sm.a[cur][kk][64 * i + 4 * ty]);
        av[4 * i] = t.x;
        av[4 * i + 1] = t.y;
        av[4 * i + 2] = t.z;
        av[4 * i + 3] = t.w;
      }
#pragma unroll
      for (int j = 0; j < TN / 4; ++j) {
        const float4 t =
            *reinterpret_cast<const float4*>(&sm.b[cur][kk][64 * j + 4 * tx]);
        bv[4 * j] = t.x;
        bv[4 * j + 1] = t.y;
        bv[4 * j + 2] = t.z;
        bv[4 * j + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // The single flush of C, in registers.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + 64 * (i / 4) + 4 * ty + i % 4;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < TN / 4; ++j) {
      const int gn = n0 + 64 * j + 4 * tx;
      if (n % 4 == 0) {
        if (gn < n)
          flush4(flush, gm, gn,
                 make_float4(acc[i][4 * j], acc[i][4 * j + 1],
                             acc[i][4 * j + 2], acc[i][4 * j + 3]));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (gn + e < n) flush(gm, gn + e, acc[i][4 * j + e]);
      }
    }
  }
}

// The mainloop on the B path the entry point chose (vec: n % 4 == 0 and B
// 16-byte aligned).
template <int BM, int BN, class ASrc, class Flush>
__device__ __forceinline__ void tile_gemm_async(const ASrc& asrc,
                                                const float* __restrict__ b,
                                                const Flush& flush, int m,
                                                int n, int k_begin, int k_end,
                                                int vec) {
  F32Stages<BM, BN>& sm = f32_stages<BM, BN>();
  if (vec)
    tile_gemm_async_loop<BM, BN, true>(sm, asrc, b, flush, m, n, k_begin,
                                       k_end);
  else
    tile_gemm_async_loop<BM, BN, false>(sm, asrc, b, flush, m, n, k_begin,
                                        k_end);
}

// out (total / n, n) = flush(Σ_{s < splits} work[s]) for the workspace
// work (splits, total / n, n): the K slices' partials summed in the fixed
// order s = 0, 1, …, then the caller's flush (bias and ReLU, and the store
// in C's dtype). One thread per float4 when n % 4 == 0 (work and out
// aligned to four elements), else per float; launched on
// reduce_blocks(total, n) blocks of kReduceThreads.
template <class Flush>
__device__ __forceinline__ void reduce_slices_into(
    const float* __restrict__ work, const Flush& flush, long long total,
    int n, int splits) {
  const long long t = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  if (n % 4 == 0) {
    const long long i = 4 * t;
    if (i >= total) return;
    float4 v = *reinterpret_cast<const float4*>(work + i);
    for (int s = 1; s < splits; ++s) {
      const float4 w =
          *reinterpret_cast<const float4*>(work + (size_t)s * total + i);
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    flush4(flush, (int)(i / n), (int)(i % n), v);
  } else {
    if (t >= total) return;
    float v = work[t];
    for (int s = 1; s < splits; ++s) v += work[(size_t)s * total + t];
    flush((int)(t / n), (int)(t % n), v);
  }
}

// reduce_slices_into an f32 out through F32Flush's bias and ReLU.
__device__ __forceinline__ void reduce_slices(const float* __restrict__ work,
                                              const float* __restrict__ bias,
                                              float* __restrict__ out,
                                              long long total, int n,
                                              int splits, int relu) {
  reduce_slices_into(work, F32Flush{bias, out, n, relu}, total, n, splits);
}

inline unsigned reduce_blocks(long long total, int n) {
  const long long items = n % 4 == 0 ? total / 4 : total;
  return (unsigned)((items + kReduceThreads - 1) / kReduceThreads);
}

}  // namespace repro
