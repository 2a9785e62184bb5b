// One block's BM x BN tile of C = flush(A · B) for int8 A (m, k) from the
// caller's A source and row-major int8 B (k, n), summed exactly in int32 on
// the int8 tensor cores: the mainloop of gemm.cu's gemm_i8 and kn2row.cu's
// unit_conv_gemms_i8 (dense A) and conv_im2col.cu's conv_im2col_i8 (A
// gathered from an NHWC map).
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
// per chunk. A k32 step wholly past K (the second of a chunk when K % 64
// is in 1..32, e.g. K 27) is skipped: it would add products of zeros. Both
// operands are staged K-contiguous, As[m][k] and Bs[n][k], with rows padded
// from 64 to 80 bytes so that a fragment load (8 rows x 4 consecutive
// words) touches 32 distinct banks. At 128 x 128 the two stages of A and B
// take 40 KB of static shared memory.
//
// A, the streamed operand, is copied in 16-byte segments: a thread owns
// segment tid % 4 (columns k0 + 16 · (tid % 4) .. + 15 of each chunk) of
// rows m0 + tid / 4 + 64 r, r < BM / 64. Where those bytes come from is
// the A source's policy (DenseI8 below; conv_im2col.cu's NHWC gather):
//   ASrc::Rows<BM / 64> rows(src, m0, row, seg)  once per block: the
//                             thread's row state (row = tid / 4);
//   rows.begin_chunk(k0)      once per chunk, before its copies: the state
//                             of the thread's column k0 + 16 seg;
//   rows.in(r), rows.at(r)    vector path: whether segment r lies in A
//                             (and in K), and its 16-byte-aligned address;
//   rows.a                    a valid address, the source of the zero-fill
//                             of a segment out of range;
//   rows.bytes(v)             byte path: every segment's 16 bytes as four
//                             words, zeros out of range.
// The vector path copies each segment with one cp.async (src-size 0 zero-
// fills it), so nothing past A's end is read. The byte path loads the next
// chunk's bytes into registers before the MMAs and stores them after.
// B is the small operand (weights, resident in L2). Its fragment wants 4
// consecutive k of one n per register, which ldmatrix.trans (16-bit
// elements) cannot produce, so B is loaded into registers as 4 (k) x 4 (n)
// byte blocks, one 32-bit word per k row, before the MMAs, and transposed
// with __byte_perm into Bs[n][k] after them.
//
// The vector path needs the A source's 16-byte condition (for dense A:
// k % 16 == 0 and A 16-byte aligned, i8_vector_path), n % 4 == 0 and B
// 4-byte aligned, decided in the entry point. Any other operand takes the
// guarded byte-wise path: the same loop with A and B gathered a byte at a
// time, masked at every edge.
//
// The flush goes through the caller's policy (QuantFlush, RawI32Flush from
// tile_gemm.cuh), masked to gm < m, gn < n: a fragment's adjacent pair
// (c0, c1), then (c2, c3), in one flush.pair when n is even, else one
// element at a time.
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

// Dense row-major int8 A (m, k) as the loop's A source.
struct DenseI8 {
  const int8_t* __restrict__ a;
  int m, k;

  template <int R>
  struct Rows {
    const int8_t* __restrict__ a;  // A itself: the zero-fill's source
    int m, k, m0, row, col, gk;    // rows m0 + row + 64 r, column gk

    __device__ __forceinline__ Rows(const DenseI8& s, int m0_, int row_,
                                    int seg)
        : a(s.a), m(s.m), k(s.k), m0(m0_), row(row_), col(16 * seg), gk(0) {}

    __device__ __forceinline__ void begin_chunk(int k0) { gk = k0 + col; }

    __device__ __forceinline__ bool in(int r) const {
      return m0 + row + 64 * r < m && gk < k;
    }

    __device__ __forceinline__ const int8_t* at(int r) const {
      return a + (size_t)(m0 + row + 64 * r) * k + gk;
    }

    __device__ __forceinline__ void bytes(uint32_t (&v)[R][4]) const {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int gm = m0 + row + 64 * r;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          uint32_t word = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kk = gk + 4 * w + e;
            if (gm < m && kk < k)
              word |= (uint32_t)(uint8_t)a[(size_t)gm * k + kk] << (8 * e);
          }
          v[r][w] = word;
        }
      }
    }
  };
};

template <int BM, int BN, bool kVec, class ASrc, class Flush>
__device__ __forceinline__ void tile_mma_i8_loop(I8Stages<BM, BN>& sm,
                                                 const ASrc& asrc,
                                                 const int8_t* __restrict__ b,
                                                 const Flush& flush, int m,
                                                 int n, int k) {
  constexpr int WM = BM / 2, WN = BN / 4;  // a warp's sub-tile
  constexpr int MI = WM / 16, NI = WN / 8;  // its m16 x n8 fragments
  constexpr int RA = BM / 64;  // A segments a thread (rows a_row + 64 r)
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

  // This thread's A segments: 16 bytes at (a_row + 64 r, a_col) of the
  // chunk.
  const int a_row = tid / 4, a_col = 16 * (tid % 4);
  typename ASrc::template Rows<RA> a_rows(asrc, m0, a_row, tid % 4);
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
    a_rows.begin_chunk(k0);
    if constexpr (kVec) {
#pragma unroll
      for (int r = 0; r < RA; ++r) {
        const bool in = a_rows.in(r);
        cp_async16(&As[stage][a_row + 64 * r][a_col],
                   in ? a_rows.at(r) : a_rows.a, in ? 16 : 0);
      }
    } else {
      a_rows.bytes(a_reg);
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
      if (ks > 0 && c * kI8Chunk + ks >= k) break;  // a k32 step past K
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
__device__ __forceinline__ void tile_mma_i8_flush(const ASrc& asrc,
                                                  const int8_t* __restrict__ b,
                                                  const Flush& flush, int m,
                                                  int n, int k, int vec) {
  __shared__ __align__(16) I8Stages<BM, BN> sm;
  if (vec)
    tile_mma_i8_loop<BM, BN, true>(sm, asrc, b, flush, m, n, k);
  else
    tile_mma_i8_loop<BM, BN, false>(sm, asrc, b, flush, m, n, k);
}

}  // namespace repro
