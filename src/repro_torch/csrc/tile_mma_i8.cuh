// One block's BM x BN tile of C = flush(A · B) for row-major int8 A (m, k)
// and B (k, n), summed exactly in int32 on the int8 tensor cores: the
// mainloop of gemm.cu's gemm_i8 and kn2row.cu's unit_conv_gemms_i8.
//
// Warps. The 256 threads are 8 warps in a 2 (M) x 4 (N) grid; a warp owns
// a (BM/2) x (BN/4) sub-tile of m16n8 fragments (4 x 4 at 128 x 128, 2 x 2
// at 64 x 64) and multiplies with mma.sync.m16n8k32.row.col.s32.s8.s8.s32,
// the plain wrapping .s32 accumulate: the callers keep K · 127² < 2^31, so
// every partial sum is exact and the result is the same integer in any
// order (each kernel equals its plain version bit for bit).
//
// K chunks. K is walked in 64-deep chunks (two k32 steps) through a
// two-stage shared-memory buffer. The loads of chunk c+1 are issued before
// the MMAs of chunk c; then cp.async.wait_group 0 and one __syncthreads
// per chunk. Both operands are staged K-contiguous, As[m][k] and Bs[n][k],
// with rows padded from 64 to 80 bytes so that a fragment load (8 rows x 4
// consecutive words) touches 32 distinct banks. At 128 x 128 the two
// stages of A and B take 40 KB of static shared memory.
//
// A, the streamed operand, is copied with 16-byte cp.async; rows past m and
// columns past k are zero-filled through the src-size operand, so nothing
// past A's end is read. B is the small operand (weights, resident in L2).
// Its fragment wants 4 consecutive k of one n per register, which
// ldmatrix.trans (16-bit elements) cannot produce, so B is loaded into
// registers as 4 (k) x 4 (n) byte blocks, one 32-bit word per k row, before
// the MMAs, and transposed with __byte_perm into Bs[n][k] after them.
//
// The vector path needs k % 16 == 0, A 16-byte aligned, n % 4 == 0 and B
// 4-byte aligned (i8_vector_path, decided in the entry point). Any other
// operand takes the guarded byte-wise path: the same loop with A and B
// gathered a byte at a time, masked at every edge.
//
// The flush goes element by element through the caller's policy
// (QuantFlush, RawI32Flush from tile_gemm.cuh), masked to gm < m, gn < n.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_gemm.cuh"

namespace repro {

constexpr int kI8Chunk = 64;              // K depth of one staged chunk
constexpr int kI8Row = kI8Chunk + 16;     // padded shared row, bytes

// Whether (a, b, n, k) can take the cp.async / word-load path.
inline bool i8_vector_path(const void* a, const void* b, int n, int k) {
  return k % 16 == 0 && n % 4 == 0 &&
         reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 4 == 0;
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared; the bytes past src_bytes (0 or 16) are zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The 4 x 4 byte block w[r] = B[k + r][n .. n+3] as four words
// t[j] = B[k .. k+3][n + j].
__device__ __forceinline__ void transpose4x4(const uint32_t* w, uint32_t* t) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
  t[0] = __byte_perm(lo01, lo23, 0x5410);
  t[1] = __byte_perm(lo01, lo23, 0x7632);
  t[2] = __byte_perm(hi01, hi23, 0x5410);
  t[3] = __byte_perm(hi01, hi23, 0x7632);
}

// The two stages of A and B in shared memory.
template <int BM, int BN>
struct I8Stages {
  int8_t a[2][BM][kI8Row];
  int8_t b[2][BN][kI8Row];
};

template <int BM, int BN, bool kVec, class Flush>
__device__ __forceinline__ void tile_mma_i8_loop(I8Stages<BM, BN>& sm,
                                                 const int8_t* __restrict__ a,
                                                 const int8_t* __restrict__ b,
                                                 const Flush& flush, int m,
                                                 int n, int k) {
  constexpr int WM = BM / 2, WN = BN / 4;  // a warp's sub-tile
  constexpr int MI = WM / 16, NI = WN / 8;  // its m16 x n8 fragments
  constexpr int RA = BM * (kI8Chunk / 16) / kThreads;  // A segments a thread
  constexpr int RB = BN / 64;  // B 4x4 blocks a thread (16 x 32 per warp)
  static_assert(kThreads == 256, "8 warps in a 2 x 4 grid");
  static_assert(BM % 64 == 0 && BN % 64 == 0, "tile edges are 64-multiples");

  auto& As = sm.a;
  auto& Bs = sm.b;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int grp = lane / 4, quad = lane % 4;  // the fragments' groupID etc.
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // This thread's A segments: 16 bytes at (row, 16 · seg) of the chunk.
  int a_row[RA], a_seg[RA];
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    const int i = tid + r * kThreads;
    a_row[r] = i / 4;
    a_seg[r] = i % 4;
  }
  // This thread's B blocks: rows 4 kb .. 4 kb + 3, columns 4 nb .. 4 nb + 3;
  // a warp covers 16 rows x 32 columns, 32 contiguous bytes per row.
  int b_kb[RB], b_nb[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int q = warp + 8 * r;
    b_nb[r] = (q % (BN / 32)) * 8 + lane % 8;
    b_kb[r] = (q / (BN / 32)) * 4 + lane / 8;
  }

  uint32_t a_reg[RA][4];  // byte path: the next chunk's A
  uint32_t b_reg[RB][4];  // the next chunk's B, one word per k row

  auto load_a = [&](int stage, int k0) {
#pragma unroll
    for (int r = 0; r < RA; ++r) {
      const int gm = m0 + a_row[r];
      const int gk = k0 + 16 * a_seg[r];
      if constexpr (kVec) {
        const bool in = gm < m && gk < k;
        cp_async16(&As[stage][a_row[r]][16 * a_seg[r]],
                   in ? a + (size_t)gm * k + gk : a, in ? 16 : 0);
      } else {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          uint32_t v = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kk = gk + 4 * w + e;
            if (gm < m && kk < k)
              v |= (uint32_t)(uint8_t)a[(size_t)gm * k + kk] << (8 * e);
          }
          a_reg[r][w] = v;
        }
      }
    }
  };
  auto store_a = [&](int stage) {
    if constexpr (!kVec) {
#pragma unroll
      for (int r = 0; r < RA; ++r)
        *reinterpret_cast<uint4*>(&As[stage][a_row[r]][16 * a_seg[r]]) =
            make_uint4(a_reg[r][0], a_reg[r][1], a_reg[r][2], a_reg[r][3]);
    }
  };
  auto load_b = [&](int k0) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int gn = n0 + 4 * b_nb[r];
#pragma unroll
      for (int kr = 0; kr < 4; ++kr) {
        const int gk = k0 + 4 * b_kb[r] + kr;
        const int8_t* row = b + (size_t)gk * n + gn;
        uint32_t v = 0;
        if constexpr (kVec) {
          if (gk < k && gn < n) v = *reinterpret_cast<const uint32_t*>(row);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (gk < k && gn + e < n)
              v |= (uint32_t)(uint8_t)row[e] << (8 * e);
        }
        b_reg[r][kr] = v;
      }
    }
  };
  auto store_b = [&](int stage) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      uint32_t t[4];
      transpose4x4(b_reg[r], t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int8_t* dst = &Bs[stage][4 * b_nb[r] + j][4 * b_kb[r]];
        *reinterpret_cast<uint32_t*>(dst) = t[j];
      }
    }
  };

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int chunks = (k + kI8Chunk - 1) / kI8Chunk;
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
      load_a(cur ^ 1, (c + 1) * kI8Chunk);
      cp_async_commit();
      load_b((c + 1) * kI8Chunk);
    }
#pragma unroll
    for (int ks = 0; ks < kI8Chunk; ks += 32) {
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int8_t* p = &As[cur][wm * WM + 16 * i + grp][ks + 4 * quad];
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kI8Row);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kI8Row + 16);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int8_t* p = &Bs[cur][wn * WN + 8 * j + grp][ks + 4 * quad];
        bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], af[i], bf[j]);
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
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gn = n0 + wn * WN + 8 * j + 2 * quad + e;
          if (gn < n) flush(gm, gn, acc[i][j][2 * h + e]);
        }
    }
}

// The mainloop on the path the entry point chose (vec: i8_vector_path).
template <int BM, int BN, class Flush>
__device__ __forceinline__ void tile_mma_i8_flush(const int8_t* __restrict__ a,
                                                  const int8_t* __restrict__ b,
                                                  const Flush& flush, int m,
                                                  int n, int k, int vec) {
  __shared__ __align__(16) I8Stages<BM, BN> sm;
  if (vec)
    tile_mma_i8_loop<BM, BN, true>(sm, a, b, flush, m, n, k);
  else
    tile_mma_i8_loop<BM, BN, false>(sm, a, b, flush, m, n, k);
}

}  // namespace repro
