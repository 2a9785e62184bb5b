// Implicit-GEMM im2col convolution with the fused bias/ReLU flush, IEEE f32,
// and its int8 form with the fused quantized flush.
//
// Replaces: src/repro/kernels/conv_im2col/conv_im2col.py::conv_im2col_call
// (body _conv_kernel): conv_im2col_f32 its f32 path, conv_im2col_i8 its
// int8 path (int8 map and weights, int32 sum, dequant → bias → ReLU →
// optional requant in the flush). On the main path the f32 kernel runs
// every conv whose input arrives in NHWC: GoogleNet's 7x7 stride-2 stem
// (224x224x3 -> 112x112x64) under layout elision, every conv without it.
//
// The GEMM is M = B·O1·O2 output pixels, N = Cout, K = K1·K2·Cin, with the
// Toeplitz matrix A never stored: each K chunk of A (16 deep in f32, 64 in
// int8) is gathered straight from the NHWC input in global memory into
// shared memory. Column gk of A is (dk1, dk2, ci) in the reference's (k1,
// k2, cin) order; row gm is (b, oy, ox). SAME padding (pad_top = ph // 2,
// pad_left = pw // 2) and the bottom/right overhang that the TPU wrapper
// pads explicitly become predicates that load 0.
//
// What bounds it on an H100: arithmetic. The stem at batch 8 does ~62 FLOP
// per byte it must move (input, weights, output), above the ~20 FLOP/byte
// ridge of 67 TFLOP/s non-tensor-core f32 over 3.35 TB/s HBM; IEEE f32 FMA
// (not TF32) keeps it at 1e-4 of the reference. Its own overhead is the
// gather: every A entry costs an index computation and a predicated copy.
//
// What the design does about it: the TPU kernel keeps the whole padded map
// resident in VMEM; the stem's padded map (229x229x3 f32, ~629 KB) is
// larger than the 227 KB of shared memory a block can have, so this kernel
// does not carry that block over. It tiles output pixels instead and
// copies only the input windows its tile needs. conv_im2col_f32 runs the
// two-stage cp.async loop of tile_gemm_async.cuh (the mainloop of the f32
// GEMMs) with A gathered from NHWC (GatherNhwcF32): once per block each of
// a thread's BM / 32 rows decodes to the offset of its window's origin and
// that origin's (iy0, ix0); once per chunk each of its two k columns
// decodes to (dk1, dk2, ci) and its offset within the window; every copy
// is then one add and two unsigned compares, 4 bytes zero-filled when the
// row, the column, iy or ix is out of range. A warp's 8 consecutive k of
// one row walk the contiguous (dk2, ci) run of one input row, so the
// copies coalesce, and cp.async.ca keeps the overlapping windows in L1.
// B, the weights as the (K1·K2·Cin, Cout) matrix, goes in 16 bytes at a
// time when Cout % 4 == 0 and w is 16-byte aligned. The output (B, O1, O2,
// Cout) is C (M, N) row-major, written once after bias and ReLU with Cout
// unpadded. A grid with fewer blocks than the card has SMs (the unelided
// 7x7 and 8x8 layers at small buckets) splits K as gemm_f32 does (S from
// kernels/gemm/gemm.py::split_k, raw partials in a workspace (S, M, N),
// conv_im2col_f32_reduce_kernel summing them in the order s = 0, 1, …):
// the same bits on every call.
//
// The int8 form runs the int8 tensor-core loop of tile_mma_i8.cuh (the
// mma.sync m16n8k32 loop of gemm_i8 and unit_conv_gemms_i8: 64-deep chunks
// in two cp.async stages, exact int32 sums) with A gathered from the int8
// NHWC map (GatherNhwcI8). On the gated Inception-v4 path it runs stem/c1
// under elision and every NHWC int8 im2col layer without it, including
// those whose input edge already carries int8 (a producer that requantized
// at this layer's scale). What bounds it there: bytes. stem/c1 at batch 8
// writes 22.7 MB of f32 output from a 2.1 MB image (K 27); the 3x3 layers
// read their maps nine times over, from L2. The entry point picks one of
// two paths (conv_i8_vector_path):
//   16-byte gather: Cin % 16 == 0, x 16-byte aligned, Cout % 4 == 0 and w
//     4-byte aligned (every layer of the gated path but stem/c1). Chunks
//     start at multiples of 64 and Cin is a multiple of 16, so each 16-byte
//     A segment of a thread lies inside one tap's channel run: one
//     cp.async from x + origin + (dk1 · W + dk2) · Cin + ci (the nine
//     reads of a 3x3 layer's map come from L2), zero-filled when the row
//     is past M, the column past K or the tap outside the map. A thread's
//     segment column is decoded once per chunk, its rows once per block.
//   bytes: any other operand (stem/c1's Cin 3, reduced widths, offset
//     views). A thread walks its segment's 16 columns once per chunk for
//     all its rows, as runs of K2 · Cin contiguous bytes, one per dk1
//     (stem/c1: three runs of 9), advancing (dk1, dk2, ci) and the offset
//     by adds, with the same predicates per byte.
// stem/c1's K of 27 is one chunk whose second k32 step the loop skips. The
// flush stores a fragment's adjacent outputs as one float2 or char2.
//
// conv_im2col_bf16 is the reference kernel's bf16 path (bf16 map and
// weights, the f32 accumulator, bias and ReLU in f32 and one cast to bf16
// at the flush, conv_im2col.py:52-60). On the main path (GoogleNet served
// in bf16) it runs the 7x7 stride-2 stem under elision and every conv
// without it. It runs the bf16 tensor-core loop of tile_mma_bf16.cuh
// (mma.sync m16n8k16, 32-deep chunks in two cp.async stages, f32 sums)
// with A gathered from the bf16 NHWC map (GatherNhwcBf16), on one of two
// paths (conv_bf16_vector_path):
//   16-byte gather: Cin % 8 == 0, x 16-byte aligned, Cout % 2 == 0 and w
//     4-byte aligned (every GoogleNet conv but the stem). A thread's
//     8-element segment starts on a multiple of 8 and so lies inside one
//     tap's channel run: one cp.async from x + origin + (dk1 · W + dk2) ·
//     Cin + ci, zero-filled when the row is past M, the column past K or
//     the tap outside the map.
//   elements: any other operand (the stem's Cin 3, reduced widths, offset
//     views): the segment's 8 columns walked in K order as runs of K2 · Cin
//     contiguous elements, two to a word, through registers.
// What bounds it: at the stem (batch 8: 2.4 MB of map, 12.8 MB of bf16
// output, 1.9 GFLOP) bytes and the gather's index work; the unelided 3x3
// layers read their maps nine times over, from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_gemm.cuh"
#include "tile_gemm_async.cuh"
#include "tile_mma_bf16.cuh"
#include "tile_mma_i8.cuh"

namespace {

// The conv as a GEMM: row gm = (b, oy, ox) of M = B·O1·O2, column gk =
// (dk1, dk2, ci) of K = K1·K2·Cin in the reference's (k1, k2, cin) order.
// The wrapper keeps every offset into x below 2^31.
struct ConvGeom {
  int h, w, c_in, k2, stride, pad_top, pad_left, o1, o2, k;

  // Row gm's image offset in x and the input position (iy0, ix0) of its
  // window's top-left tap (negative inside the top/left pad).
  __device__ __forceinline__ void row(int gm, int& base, int& iy0,
                                      int& ix0) const {
    const int per_image = o1 * o2;
    const int bi = gm / per_image;
    const int rem = gm - bi * per_image;
    const int oy = rem / o2;
    const int ox = rem - oy * o2;
    base = bi * h * w * c_in;
    iy0 = oy * stride - pad_top;
    ix0 = ox * stride - pad_left;
  }

  // Column gk's tap (dk1, dk2) and channel ci.
  __device__ __forceinline__ void column(int gk, int& dk1, int& dk2,
                                         int& ci) const {
    const int tap = gk / c_in;
    ci = gk - tap * c_in;
    dk1 = tap / k2;
    dk2 = tap - dk1 * k2;
  }
};

// Far outside any map: an iy0 or dk1 of kFar puts every iy out of range,
// which marks a row past M or a column past the K slice.
constexpr int kFar = -(1 << 29);

// A = the Toeplitz matrix of f32 x (B, H, W, Cin) as the A source of
// tile_gemm_async.cuh's loop. Per thread, rows m0 + row + 32 i keep the
// offset of their window's origin, (iy0 · W + ix0) · Cin into their image,
// and (iy0, ix0); columns col + 8 j of the chunk keep (dk1, dk2) and their
// offset (dk1 · W + dk2) · Cin + ci within a window. Entry (i, j) is then
// x[origin_i + tap_j], in range when 0 <= iy0_i + dk1_j < H and 0 <= ix0_i +
// dk2_j < W: XLA's SAME split (pad_top = ph // 2) and the bottom/right
// overhang are these predicates.
struct GatherNhwcF32 {
  const float* __restrict__ x;
  ConvGeom g;
  int m;

  template <int R>
  struct Rows {
    const float* __restrict__ a;  // x itself: the zero-fill's source
    ConvGeom g;
    int col;
    int origin[R], iy0[R], ix0[R];  // per row (iy0 kFar: past M)
    int tap[2], dk1[2], dk2[2];     // per column (dk1 kFar: past the slice)

    __device__ __forceinline__ Rows(const GatherNhwcF32& s, int m0, int row,
                                    int col_)
        : a(s.x), g(s.g), col(col_) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int gm = m0 + row + 32 * i;
        if (gm < s.m) {
          int base;
          g.row(gm, base, iy0[i], ix0[i]);
          origin[i] = base + (iy0[i] * g.w + ix0[i]) * g.c_in;
        } else {
          origin[i] = ix0[i] = 0;
          iy0[i] = kFar;
        }
      }
    }

    __device__ __forceinline__ void begin_chunk(int k0, int k_end) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int gk = k0 + col + 8 * j;
        int ci;
        g.column(gk, dk1[j], dk2[j], ci);
        tap[j] = (dk1[j] * g.w + dk2[j]) * g.c_in + ci;
        if (gk >= k_end) dk1[j] = kFar;
      }
    }

    __device__ __forceinline__ bool in(int i, int j, int, int) const {
      return (unsigned)(iy0[i] + dk1[j]) < (unsigned)g.h &&
             (unsigned)(ix0[i] + dk2[j]) < (unsigned)g.w;
    }

    __device__ __forceinline__ const float* at(int i, int j, int) const {
      return a + (origin[i] + tap[j]);
    }
  };
};

// A = the Toeplitz matrix of int8 x (B, H, W, Cin) as the A source of
// tile_mma_i8.cuh's loop. Per thread, rows m0 + row + 64 r keep their
// window origin and (iy0, ix0) as in GatherNhwcF32; the chunk's column
// k0 + 16 seg keeps (dk1, dk2, ci), its offset within a window and how many
// columns are left in K.
struct GatherNhwcI8 {
  const int8_t* __restrict__ x;
  ConvGeom g;
  int m;

  template <int R>
  struct Rows {
    const int8_t* __restrict__ a;   // x itself: the zero-fill's source
    ConvGeom g;
    int col;
    int origin[R], iy0[R], ix0[R];  // per row (iy0 kFar: past M)
    int tap, dk1, dk2, ci, left;    // the column (dk1 kFar: past K)

    __device__ __forceinline__ Rows(const GatherNhwcI8& s, int m0, int row,
                                    int seg)
        : a(s.x), g(s.g), col(16 * seg) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int gm = m0 + row + 64 * r;
        if (gm < s.m) {
          int base;
          g.row(gm, base, iy0[r], ix0[r]);
          origin[r] = base + (iy0[r] * g.w + ix0[r]) * g.c_in;
        } else {
          origin[r] = ix0[r] = 0;
          iy0[r] = kFar;
        }
      }
    }

    __device__ __forceinline__ void begin_chunk(int k0) {
      const int gk = k0 + col;
      g.column(gk, dk1, dk2, ci);
      tap = (dk1 * g.w + dk2) * g.c_in + ci;
      left = g.k - gk;
      if (left <= 0) dk1 = kFar;
    }

    // The 16-byte path (Cin % 16 == 0): the segment is one tap's channels.
    __device__ __forceinline__ bool in(int r) const {
      return (unsigned)(iy0[r] + dk1) < (unsigned)g.h &&
             (unsigned)(ix0[r] + dk2) < (unsigned)g.w;
    }

    __device__ __forceinline__ const int8_t* at(int r) const {
      return a + (origin[r] + tap);
    }

    // The byte path: columns k0 + col + e, e < 16, walked in K order; the
    // offset steps by 1 along a (dk2, ci) run and by 1 + (W - K2) · Cin
    // from one run (dk1) to the next.
    __device__ __forceinline__ void bytes(uint32_t (&v)[R][4]) const {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int w = 0; w < 4; ++w) v[r][w] = 0;
      int d1 = dk1, d2 = dk2, c = ci, off = tap;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        if (e < left) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            if ((unsigned)(iy0[r] + d1) < (unsigned)g.h &&
                (unsigned)(ix0[r] + d2) < (unsigned)g.w)
              v[r][e / 4] |= (uint32_t)(uint8_t)a[origin[r] + off]
                             << (8 * (e % 4));
        }
        ++off;
        if (++c == g.c_in) {
          c = 0;
          if (++d2 == g.k2) {
            d2 = 0;
            ++d1;
            off += (g.w - g.k2) * g.c_in;
          }
        }
      }
    }
  };
};

// A = the Toeplitz matrix of bf16 x (B, H, W, Cin), elements as 16-bit
// patterns, as the A source of tile_mma_bf16.cuh's loop: GatherNhwcI8 with
// elements for bytes. Per thread, rows m0 + row + 64 r keep their window
// origin and (iy0, ix0); the chunk's column k0 + 8 seg keeps (dk1, dk2, ci),
// its offset within a window and how many columns are left in K.
struct GatherNhwcBf16 {
  const uint16_t* __restrict__ x;
  ConvGeom g;
  int m;

  template <int R>
  struct Rows {
    const uint16_t* __restrict__ a;  // x itself: the zero-fill's source
    ConvGeom g;
    int col;
    int origin[R], iy0[R], ix0[R];   // per row (iy0 kFar: past M)
    int tap, dk1, dk2, ci, left;     // the column (dk1 kFar: past K)

    __device__ __forceinline__ Rows(const GatherNhwcBf16& s, int m0, int row,
                                    int seg)
        : a(s.x), g(s.g), col(8 * seg) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int gm = m0 + row + 64 * r;
        if (gm < s.m) {
          int base;
          g.row(gm, base, iy0[r], ix0[r]);
          origin[r] = base + (iy0[r] * g.w + ix0[r]) * g.c_in;
        } else {
          origin[r] = ix0[r] = 0;
          iy0[r] = kFar;
        }
      }
    }

    __device__ __forceinline__ void begin_chunk(int k0) {
      const int gk = k0 + col;
      g.column(gk, dk1, dk2, ci);
      tap = (dk1 * g.w + dk2) * g.c_in + ci;
      left = g.k - gk;
      if (left <= 0) dk1 = kFar;
    }

    // The 16-byte path (Cin % 8 == 0): the segment is one tap's channels.
    __device__ __forceinline__ bool in(int r) const {
      return (unsigned)(iy0[r] + dk1) < (unsigned)g.h &&
             (unsigned)(ix0[r] + dk2) < (unsigned)g.w;
    }

    __device__ __forceinline__ const uint16_t* at(int r) const {
      return a + (origin[r] + tap);
    }

    // The element path: columns k0 + col + e, e < 8, walked in K order; the
    // offset steps by 1 along a (dk2, ci) run and by 1 + (W - K2) · Cin
    // from one run (dk1) to the next.
    __device__ __forceinline__ void elems(uint32_t (&v)[R][4]) const {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int w = 0; w < 4; ++w) v[r][w] = 0;
      int d1 = dk1, d2 = dk2, c = ci, off = tap;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (e < left) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            if ((unsigned)(iy0[r] + d1) < (unsigned)g.h &&
                (unsigned)(ix0[r] + d2) < (unsigned)g.w)
              v[r][e / 2] |= (uint32_t)a[origin[r] + off] << (16 * (e % 2));
        }
        ++off;
        if (++c == g.c_in) {
          c = 0;
          if (++d2 == g.k2) {
            d2 = 0;
            ++d1;
            off += (g.w - g.k2) * g.c_in;
          }
        }
      }
    }
  };
};

// K slice blockIdx.z of gridDim.z: the whole conv with the fused flush
// when the grid has one slice, else the slice's raw partial into
// work[blockIdx.z] (m, n).
template <int BM, int BN>
__global__ void __launch_bounds__(repro::kThreads)
    conv_im2col_f32_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ bias,
                           float* __restrict__ out, float* __restrict__ work,
                           ConvGeom g, int m, int n, int relu, int vec) {
  const int splits = gridDim.z;
  const GatherNhwcF32 src{x, g, m};
  if (splits == 1) {
    repro::tile_gemm_async<BM, BN>(src, w,
                                   repro::F32Flush{bias, out, n, relu}, m, n,
                                   0, g.k, vec);
    return;
  }
  const int s = blockIdx.z;
  const int depth = repro::slice_depth(g.k, splits);
  repro::tile_gemm_async<BM, BN>(
      src, w, repro::RawF32Flush{work + (size_t)s * m * n, n}, m, n,
      s * depth, min(g.k, (s + 1) * depth), vec);
}

__global__ void __launch_bounds__(repro::kReduceThreads)
    conv_im2col_f32_reduce_kernel(const float* __restrict__ work,
                                  const float* __restrict__ bias,
                                  float* __restrict__ out, long long total,
                                  int n, int splits, int relu) {
  repro::reduce_slices(work, bias, out, total, n, splits, relu);
}

template <int BM, int BN>
__global__ void __launch_bounds__(repro::kThreads)
    conv_im2col_i8_kernel(const int8_t* __restrict__ x,
                          const int8_t* __restrict__ w,
                          repro::QuantFlush flush, ConvGeom g, int m, int n,
                          int vec) {
  repro::tile_mma_i8_flush<BM, BN>(GatherNhwcI8{x, g, m}, w, flush, m, n,
                                   g.k, vec);
}

template <int BM, int BN>
__global__ void __launch_bounds__(repro::kThreads)
    conv_im2col_bf16_kernel(const uint16_t* __restrict__ x,
                            const uint16_t* __restrict__ w,
                            const __nv_bfloat16* __restrict__ bias,
                            __nv_bfloat16* __restrict__ out, ConvGeom g,
                            int m, int n, int relu, int vec) {
  repro::tile_mma_bf16_flush<BM, BN>(
      GatherNhwcBf16{x, g, m}, w,
      repro::CastFlush<__nv_bfloat16, __nv_bfloat16>{bias, out, n, relu}, m,
      n, g.k, vec);
}

// Whether conv_im2col_bf16 takes the 16-byte gather path (else the element
// path); kernels/conv_im2col/conv_im2col.py::BF16_GATHER_RULE mirrors it.
inline bool conv_bf16_vector_path(const void* x, const void* w, int c_in,
                                  int c_out) {
  return c_in % 8 == 0 && c_out % 2 == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 4 == 0;
}

// Whether conv_im2col_i8 takes the 16-byte gather path (else the byte
// path); kernels/conv_im2col/conv_im2col.py::I8_GATHER_RULE mirrors it.
inline bool conv_i8_vector_path(const void* x, const void* w, int c_in,
                                int c_out) {
  return c_in % 16 == 0 && c_out % 4 == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 4 == 0;
}

}  // namespace

// out (B, O1, O2, Cout) = epilogue(conv(x (B, H, W, Cin), w) [+ bias]),
// w (K1, K2, Cin, Cout) read as the (K1·K2·Cin, Cout) matrix; all f32,
// contiguous, on the current device, out 16-byte aligned, every offset
// into x below 2^31. bias may be NULL. Padding is given as the top/left
// pad; bottom/right overhang reads as 0. (tile_m, tile_n) must be an
// instantiated tile: 64 or 128 each. K = K1·K2·Cin is cut into `splits`
// slices (slice_depth); with splits > 1, work is the f32 workspace
// (splits, B·O1·O2, Cout) and a second kernel on the same stream sums the
// slices in order into out. vec: Cout % 4 == 0 and w 16-byte aligned.
// Returns cudaGetLastError().
extern "C" int conv_im2col_f32(const void* x, const void* w, const void* bias,
                               void* out, void* work, int batch, int h,
                               int w_in, int c_in, int k1, int k2, int stride,
                               int pad_top, int pad_left, int o1, int o2,
                               int c_out, int tile_m, int tile_n, int relu,
                               int splits, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ConvGeom g{h,        w_in,     c_in, k2, stride,
                   pad_top,  pad_left, o1,   o2, k1 * k2 * c_in};
  const int m = batch * o1 * o2;
  REPRO_DISPATCH_TILE(conv_im2col_f32_kernel, tile_m, tile_n, m, c_out,
                      splits, st, static_cast<const float*>(x),
                      static_cast<const float*>(w),
                      static_cast<const float*>(bias),
                      static_cast<float*>(out), static_cast<float*>(work), g,
                      m, c_out, relu, vec);
  const int err = (int)cudaGetLastError();
  if (err != 0 || splits == 1) return err;
  const long long total = (long long)m * c_out;
  conv_im2col_f32_reduce_kernel<<<repro::reduce_blocks(total, c_out),
                                  repro::kReduceThreads, 0, st>>>(
      static_cast<const float*>(work), static_cast<const float*>(bias),
      static_cast<float*>(out), total, c_out, splits, relu);
  return (int)cudaGetLastError();
}

// out (B, O1, O2, Cout) = flush(conv(x (B, H, W, Cin), w)) with x and w
// (K1, K2, Cin, Cout) int8 and the sum exact in int32; the flush is
// v = (float)sum · scale[c] [+ bias[c]] [ReLU], stored as f32, or, when
// requant is nonzero, as int8: clamp(round-half-even(v / out_scale),
// ±127). scale (Cout) f32; bias may be NULL; all contiguous, on the
// current device, out allocated by the caller (8-byte aligned); the caller
// keeps K1·K2·Cin · 127² < 2^31. Geometry and tiles as conv_im2col_f32;
// the path is conv_i8_vector_path's. Returns cudaGetLastError().
extern "C" int conv_im2col_i8(const void* x, const void* w, const void* scale,
                              const void* bias, void* out, int batch, int h,
                              int w_in, int c_in, int k1, int k2, int stride,
                              int pad_top, int pad_left, int o1, int o2,
                              int c_out, int tile_m, int tile_n, int relu,
                              int requant, float out_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ConvGeom g{h,        w_in,     c_in, k2, stride,
                   pad_top,  pad_left, o1,   o2, k1 * k2 * c_in};
  const int m = batch * o1 * o2;
  const repro::QuantFlush flush{
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      requant ? nullptr : static_cast<float*>(out),
      requant ? static_cast<int8_t*>(out) : nullptr, out_scale, c_out, relu};
  REPRO_DISPATCH_TILE(conv_im2col_i8_kernel, tile_m, tile_n, m, c_out, 1, s,
                      static_cast<const int8_t*>(x),
                      static_cast<const int8_t*>(w), flush, g, m, c_out,
                      (int)conv_i8_vector_path(x, w, c_in, c_out));
  return (int)cudaGetLastError();
}

// out (B, O1, O2, Cout) = epilogue(conv(x (B, H, W, Cin), w) [+ bias]) with
// x, w (K1, K2, Cin, Cout), bias and out bf16, the sum in f32 on the
// tensor cores and bias and ReLU in f32 before one round-to-nearest-even
// store; all contiguous, on the current device, every offset into x below
// 2^31. bias may be NULL. Geometry and tiles as conv_im2col_f32; the path
// is conv_bf16_vector_path's. Returns cudaGetLastError().
extern "C" int conv_im2col_bf16(const void* x, const void* w, const void* bias,
                                void* out, int batch, int h, int w_in,
                                int c_in, int k1, int k2, int stride,
                                int pad_top, int pad_left, int o1, int o2,
                                int c_out, int tile_m, int tile_n, int relu,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ConvGeom g{h,        w_in,     c_in, k2, stride,
                   pad_top,  pad_left, o1,   o2, k1 * k2 * c_in};
  const int m = batch * o1 * o2;
  REPRO_DISPATCH_TILE(conv_im2col_bf16_kernel, tile_m, tile_n, m, c_out, 1, s,
                      static_cast<const uint16_t*>(x),
                      static_cast<const uint16_t*>(w),
                      static_cast<const __nv_bfloat16*>(bias),
                      static_cast<__nv_bfloat16*>(out), g, m, c_out, relu,
                      (int)conv_bf16_vector_path(x, w, c_in, c_out));
  return (int)cudaGetLastError();
}
