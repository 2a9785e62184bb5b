// Implicit-GEMM im2col convolution with the fused bias/ReLU flush, IEEE f32.
//
// Replaces: src/repro/kernels/conv_im2col/conv_im2col.py::conv_im2col_call
// (body _conv_kernel). On the main path it runs every conv whose input
// arrives in NHWC: GoogleNet's 7x7 stride-2 stem (224x224x3 -> 112x112x64)
// under layout elision, every conv without it.
//
// The GEMM is M = B·O1·O2 output pixels, N = Cout, K = K1·K2·Cin, with the
// Toeplitz matrix A never stored: each 16-deep K chunk of A is gathered
// straight from the NHWC input in global memory into shared memory. Column
// gk of A is (dk1, dk2, ci) in the reference's (k1, k2, cin) order; row gm
// is (b, oy, ox). SAME padding (pad_top = ph // 2, pad_left = pw // 2) and
// the bottom/right overhang that the TPU wrapper pads explicitly become
// predicates that load 0.
//
// What bounds it on an H100: arithmetic. The stem at batch 8 does ~62 FLOP
// per byte it must move (input, weights, output), above the ~20 FLOP/byte
// ridge of 67 TFLOP/s non-tensor-core f32 over 3.35 TB/s HBM; IEEE f32 FMA
// (not TF32) keeps it at 1e-4 of the reference. Its own overhead is the
// gather: every A entry costs an index computation and a predicated load.
//
// What the design does about it: the TPU kernel keeps the whole padded map
// resident in VMEM; the stem's padded map (229x229x3 f32, ~629 KB) is
// larger than the 227 KB of shared memory a block can have, so this kernel
// does not carry that block over. It tiles output pixels instead and
// gathers only the input windows its tile needs (neighbouring output
// pixels read neighbouring addresses along the (dk2, ci) run, so the
// gather coalesces); each thread decodes its rows' (b, oy, ox) once and
// its column's (dk1, dk2, ci) once per chunk. The output is written once,
// after bias and ReLU, with Cout unpadded.
#include <cuda_runtime.h>

#include "tile_gemm.cuh"

namespace {

struct ConvGeom {
  int h, w, c_in, k2, stride, pad_top, pad_left, o1, o2, k;
};

// A = the Toeplitz matrix of x (B, H, W, Cin), gathered on the fly.
template <int R>
struct GatherA {
  const float* __restrict__ x;
  ConvGeom g;
  long long base[R];  // offset of image b in x; -1 past the last row
  int iy0[R], ix0[R];
  int dk1, dk2, ci;
  bool k_ok;

  __device__ GatherA(const float* x_, const ConvGeom& g_, int row0, int m)
      : x(x_), g(g_), dk1(0), dk2(0), ci(0), k_ok(false) {
    const int per_image = g.o1 * g.o2;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int gm = row0 + 16 * r;
      if (gm < m) {
        const int bi = gm / per_image;
        const int rem = gm - bi * per_image;
        const int oy = rem / g.o2;
        const int ox = rem - oy * g.o2;
        base[r] = (long long)bi * g.h * g.w * g.c_in;
        iy0[r] = oy * g.stride - g.pad_top;
        ix0[r] = ox * g.stride - g.pad_left;
      } else {
        base[r] = -1;
        iy0[r] = ix0[r] = 0;
      }
    }
  }

  __device__ __forceinline__ void begin_chunk(int gk) {
    k_ok = gk < g.k;
    const int tap = gk / g.c_in;
    ci = gk - tap * g.c_in;
    dk1 = tap / g.k2;
    dk2 = tap - dk1 * g.k2;
  }

  __device__ __forceinline__ float load(int r) const {
    if (!k_ok || base[r] < 0) return 0.f;
    const int iy = iy0[r] + dk1;
    const int ix = ix0[r] + dk2;
    if (iy < 0 || iy >= g.h || ix < 0 || ix >= g.w) return 0.f;
    return x[base[r] + ((long long)iy * g.w + ix) * g.c_in + ci];
  }
};

template <int BM, int BN>
__global__ void __launch_bounds__(repro::kThreads)
    conv_im2col_f32_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ bias,
                           float* __restrict__ out, ConvGeom g, int m, int n,
                           int relu) {
  GatherA<BM / 16> lda(x, g, blockIdx.y * BM + threadIdx.x / 16, m);
  repro::tile_gemm<BM, BN>(lda, w, bias, out, m, n, g.k, relu);
}

}  // namespace

// out (B, O1, O2, Cout) = epilogue(conv(x (B, H, W, Cin), w) [+ bias]),
// w (K1, K2, Cin, Cout) read as the (K1·K2·Cin, Cout) matrix; all f32,
// contiguous, on the current device. bias may be NULL. Padding is given
// as the top/left pad; bottom/right overhang reads as 0. (tile_m, tile_n)
// must be an instantiated tile: 64 or 128 each. Returns cudaGetLastError().
extern "C" int conv_im2col_f32(const void* x, const void* w, const void* bias,
                               void* out, int batch, int h, int w_in,
                               int c_in, int k1, int k2, int stride,
                               int pad_top, int pad_left, int o1, int o2,
                               int c_out, int tile_m, int tile_n, int relu,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ConvGeom g{h,        w_in,     c_in, k2, stride,
                   pad_top,  pad_left, o1,   o2, k1 * k2 * c_in};
  const int m = batch * o1 * o2;
  REPRO_DISPATCH_TILE(conv_im2col_f32_kernel, tile_m, tile_n, m, c_out, s,
                      static_cast<const float*>(x),
                      static_cast<const float*>(w),
                      static_cast<const float*>(bias),
                      static_cast<float*>(out), g, m, c_out, relu);
  return (int)cudaGetLastError();
}
