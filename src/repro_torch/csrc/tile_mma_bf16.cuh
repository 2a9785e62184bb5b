// One block's BM x BN tile of C = flush(A · B) for bf16 A (m, k) from the
// caller's A source and row-major bf16 B (k, n), summed in f32 on the bf16
// tensor cores: the mainloop of conv_im2col.cu's conv_im2col_bf16 (A
// gathered from an NHWC map), kn2row.cu's unit_conv_gemms_bf16 and gemm.cu's
// gemm_bf16_mma and batched_gemm_bf16_mma (dense A: the operands
// tile_wgmma_bf16.cuh's TMA cannot address).
//
// It is tile_mma_i8.cuh's loop with 16-bit elements. A 32-deep bf16 chunk
// is the int8 loop's 64-byte chunk, and the m16n8k16 bf16 fragments hold
// the same bytes as the m16n8k32 int8 ones: a0 = row grp, bytes 4 quad ..
// 4 quad + 3 of the k step; a1 eight rows down; a2, a3 sixteen bytes on;
// b0, b1 the same bytes of column grp of B^T. So the shared-memory layout
// (As[m][k] and Bs[n][k], rows padded from 64 to 80 bytes, two stages,
// 40 KB at 128 x 128), the 16-byte cp.async segments of A, the warp grid
// (2 (M) x 4 (N) warps, each (BM/2) x (BN/4) of m16n8 fragments) and the
// fragment loads carry over byte for byte; only the MMA
// (mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, f32 accumulators)
// and B's transpose differ. The second k16 step of a chunk is skipped when
// it lies wholly past K.
//
// A, the streamed operand: a thread owns segment tid % 4 (8 elements,
// columns k0 + 8 (tid % 4) .. + 7 of each chunk) of rows m0 + tid / 4 +
// 64 r, r < BM / 64. The A source's policy is the int8 loop's, with
// elements for bytes:
//   ASrc::Rows<BM / 64> rows(src, m0, row, seg), rows.begin_chunk(k0),
//   rows.in(r), rows.at(r) and rows.a  as tile_mma_i8.cuh says;
//   rows.elems(v)  element path: the segment's 8 elements as four words
//                  (two elements each, the lower column in the low half),
//                  zeros out of range.
// B (weights, resident in L2): a thread owns BN / 64 blocks of 4 (k) x 2
// (n) elements, one 32-bit word per k row (a warp covers 8 rows x 32
// columns, 64 contiguous bytes per row), loaded into registers before the
// MMAs and transposed after them with __byte_perm into Bs[n][k]: two
// 8-byte stores of four consecutive k, one per column.
//
// The vector path needs the A source's 16-byte condition (dense A:
// k % 8 == 0 and A 16-byte aligned, bf16_vector_path), n % 2 == 0 and B
// 4-byte aligned, decided in the entry point; any other operand takes the
// element path, masked at every edge. The flush goes through the caller's
// policy (CastFlush in tile_gemm.cuh): the f32 sum, bias widened, ReLU,
// one round-to-nearest-even store, a fragment's adjacent pair in one
// flush.pair when n is even.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_gemm.cuh"
#include "tile_mma_i8.cuh"

namespace repro {

constexpr int kBf16Chunk = 32;  // K depth of one staged chunk, elements

// Whether dense (a, b, n, k) can take the cp.async / word-load path.
inline bool bf16_vector_path(const void* a, const void* b, int n, int k) {
  return k % 8 == 0 && n % 2 == 0 &&
         reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 4 == 0;
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Dense row-major bf16 A (m, k), its elements as 16-bit patterns.
struct DenseBf16 {
  const uint16_t* __restrict__ a;
  int m, k;

  template <int R>
  struct Rows {
    const uint16_t* __restrict__ a;  // A itself: the zero-fill's source
    int m, k, m0, row, col, gk;      // rows m0 + row + 64 r, column gk

    __device__ __forceinline__ Rows(const DenseBf16& s, int m0_, int row_,
                                    int seg)
        : a(s.a), m(s.m), k(s.k), m0(m0_), row(row_), col(8 * seg), gk(0) {}

    __device__ __forceinline__ void begin_chunk(int k0) { gk = k0 + col; }

    __device__ __forceinline__ bool in(int r) const {
      return m0 + row + 64 * r < m && gk < k;
    }

    __device__ __forceinline__ const uint16_t* at(int r) const {
      return a + (size_t)(m0 + row + 64 * r) * k + gk;
    }

    __device__ __forceinline__ void elems(uint32_t (&v)[R][4]) const {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int gm = m0 + row + 64 * r;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          uint32_t word = 0;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kk = gk + 2 * w + e;
            if (gm < m && kk < k)
              word |= (uint32_t)a[(size_t)gm * k + kk] << (16 * e);
          }
          v[r][w] = word;
        }
      }
    }
  };
};

template <int BM, int BN, bool kVec, class ASrc, class Flush>
__device__ __forceinline__ void tile_mma_bf16_loop(
    I8Stages<BM, BN>& sm, const ASrc& asrc, const uint16_t* __restrict__ b,
    const Flush& flush, int m, int n, int k) {
  constexpr int WM = BM / 2, WN = BN / 4;   // a warp's sub-tile
  constexpr int MI = WM / 16, NI = WN / 8;  // its m16 x n8 fragments
  constexpr int RA = BM / 64;  // A segments a thread (rows a_row + 64 r)
  constexpr int RB = BN / 64;  // B 4x2 blocks a thread (8 x 32 per warp)
  static_assert(kThreads == 256, "8 warps in a 2 x 4 grid");
  static_assert(BM % 64 == 0 && BN % 64 == 0, "tile edges are 64-multiples");

  auto& As = sm.a;
  auto& Bs = sm.b;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int grp = lane / 4, quad = lane % 4;  // the fragments' groupID etc.
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // This thread's A segments: 16 bytes at (a_row + 64 r, byte a_col) of
  // the chunk.
  const int a_row = tid / 4, a_col = 16 * (tid % 4);
  typename ASrc::template Rows<RA> a_rows(asrc, m0, a_row, tid % 4);
  // This thread's B blocks: k rows 4 kb .. 4 kb + 3, columns 2 nb, 2 nb + 1.
  int b_kb[RB], b_nb[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int q = warp + 8 * r;
    b_nb[r] = (q % (BN / 32)) * 16 + lane % 16;
    b_kb[r] = (q / (BN / 32)) * 2 + lane / 16;
  }

  uint32_t a_reg[RA][4];  // element path: the next chunk's A
  uint32_t b_reg[RB][4];  // the next chunk's B, one word per k row

  auto load_a = [&](int stage, int k0) {
    a_rows.begin_chunk(k0);
    if constexpr (kVec) {
#pragma unroll
      for (int r = 0; r < RA; ++r) {
        const bool in = a_rows.in(r);
        cp_async16(&As[stage][a_row + 64 * r][a_col],
                   in ? a_rows.at(r) : a_rows.a, in ? 16 : 0);
      }
    } else {
      a_rows.elems(a_reg);
    }
  };
  auto store_a = [&](int stage) {
    if constexpr (!kVec) {
#pragma unroll
      for (int r = 0; r < RA; ++r)
        *reinterpret_cast<uint4*>(&As[stage][a_row + 64 * r][a_col]) =
            make_uint4(a_reg[r][0], a_reg[r][1], a_reg[r][2], a_reg[r][3]);
    }
  };
  auto load_b = [&](int k0) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int gn = n0 + 2 * b_nb[r];
#pragma unroll
      for (int kr = 0; kr < 4; ++kr) {
        const int gk = k0 + 4 * b_kb[r] + kr;
        const uint16_t* row = b + (size_t)gk * n + gn;
        uint32_t v = 0;
        if constexpr (kVec) {
          if (gk < k && gn < n) v = *reinterpret_cast<const uint32_t*>(row);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (gk < k && gn + e < n) v |= (uint32_t)row[e] << (16 * e);
        }
        b_reg[r][kr] = v;
      }
    }
  };
  auto store_b = [&](int stage) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const uint32_t* w = b_reg[r];
      int8_t* dst = &Bs[stage][2 * b_nb[r]][8 * b_kb[r]];
      // Column 2 nb: the low halves of the four k rows; 2 nb + 1: the high.
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(__byte_perm(w[0], w[1], 0x5410),
                     __byte_perm(w[2], w[3], 0x5410));
      *reinterpret_cast<uint2*>(dst + kI8Row) =
          make_uint2(__byte_perm(w[0], w[1], 0x7632),
                     __byte_perm(w[2], w[3], 0x7632));
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int chunks = (k + kBf16Chunk - 1) / kBf16Chunk;
  load_a(0, 0);
  cp_async_commit();
  load_b(0);
  store_a(0);
  store_b(0);
  cp_async_wait_all();
  __syncthreads();

  for (int c = 0; c < chunks; ++c) {
    const int cur = c & 1;
    const bool more = c + 1 < chunks;
    if (more) {  // chunk c+1 in flight while chunk c multiplies
      load_a(cur ^ 1, (c + 1) * kBf16Chunk);
      cp_async_commit();
      load_b((c + 1) * kBf16Chunk);
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {  // two k16 steps, 32 bytes each
      if (ks > 0 && c * kBf16Chunk + 16 >= k) break;  // a k16 step past K
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int8_t* p = &As[cur][wm * WM + 16 * i + grp][32 * ks + 4 * quad];
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kI8Row);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kI8Row + 16);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int8_t* p = &Bs[cur][wn * WN + 8 * j + grp][32 * ks + 4 * quad];
        bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
    if (more) {
      store_a(cur ^ 1);
      store_b(cur ^ 1);
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // c0, c1 at row grp, columns 2 quad + {0, 1}; c2, c3 eight rows down.
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wm * WM + 16 * i + grp + 8 * h;
      if (gm >= m) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int gn = n0 + wn * WN + 8 * j + 2 * quad;  // even
        if (n % 2 == 0) {
          if (gn < n)
            flush.pair(gm, gn, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (gn + e < n) flush(gm, gn + e, acc[i][j][2 * h + e]);
        }
      }
    }
}

// The mainloop on the path the entry point chose (vec: the A source's
// 16-byte condition and B's word condition).
template <int BM, int BN, class ASrc, class Flush>
__device__ __forceinline__ void tile_mma_bf16_flush(
    const ASrc& asrc, const uint16_t* __restrict__ b, const Flush& flush,
    int m, int n, int k, int vec) {
  __shared__ __align__(16) I8Stages<BM, BN> sm;
  if (vec)
    tile_mma_bf16_loop<BM, BN, true>(sm, asrc, b, flush, m, n, k);
  else
    tile_mma_bf16_loop<BM, BN, false>(sm, asrc, b, flush, m, n, k);
}

}  // namespace repro
