// Winograd F(m,3) transforms, f32 and bf16: the input transform (from NHWC
// or from the stored tile layout) and the output transform with the fused
// bias/ReLU flush. The transform-space products between them run on
// gemm.cu's batched GEMM.
//
// Replaces, in src/repro/kernels/winograd/winograd.py:
//   input_transform        -> winograd_input_transform_{f32,bf16}
//   input_transform_tiles  -> winograd_input_transform_tiles_{f32,bf16}
//   output_transform       -> winograd_output_transform_{f32,bf16}
// On the main path (full-width VGG16, in f32 or with bf16 params) the five
// F(4,3) layers read their stored tiles through the tiles transform under
// layout elision, and NHWC through the input transform without it; every
// one ends in the output transform.
//
// Element types: each kernel body is templated on the element T of its
// tensors (float or __nv_bfloat16; the output transform's bias too). As in
// the reference's kernels (.astype(jnp.float32) on load, .astype(v_ref.dtype)
// on store), every load widens to f32, the transform arithmetic, bias and
// ReLU stay in IEEE f32, and the single store rounds once to T
// (__float2bfloat16_rn for bf16). The f32 and bf16 instantiations are
// __global__ functions of their own names (input_transform_kernel<M>,
// input_transform_bf16_kernel<M>, ...), so a profile tells them apart.
//
// Layouts, as in the reference: V and M are the "scattered" layout
// (T², n, C) with T = m + 2, n = B·tiles_y·tiles_x, tile index b·tiles +
// ty·tiles_x + tx, so the batched GEMM's batch index is the intra-tile
// position ξν. The stored tile layout is (n, T, T, C).
//
// What bounds them on an H100: bytes (half of them in bf16, whose ~2·T FLOP
// per value are the same f32 work). Each output value takes ~2·T FLOP per
// input value (two 1-D passes of adds and small-constant FMAs), far below
// the ~20 FLOP per byte where 67 TFLOP/s of f32 meets 3.35 TB/s of HBM.
// The input transform reads each NHWC pixel (T/m)² times over the
// overlapping windows (2.25x for F(4,3)); those repeats hit in L2.
//
// What the design does about it: one thread per (tile, channel), with the
// channel fastest, so every load and store of a warp covers 32 consecutive
// elements of C (128 bytes in f32, 64 in bf16). A thread keeps its T x T tile
// in registers, applies the 1-D transform down the columns and then along the
// rows (Bᵀ d B, Aᵀ M A) with the matrices' constants written out, and stores
// once. The TPU kernel holds the whole padded map in VMEM (VGG16's conv0_1 map
// is ~13 MB per image, far above a block's 227 KB of shared memory), so here
// each thread reads its window from global memory instead; the SAME halo and
// the bottom/right fill that the reference pads on the host are predicates that
// load 0. The output transform writes only the in-range pixels of each m x m
// block straight into (B, O1, O2, C): no crop copy. Staging through shared
// memory and fusing the transforms into the GEMM are later work, as is a bf16
// design of its own (two channels a thread, paired loads and stores).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile_gemm.cuh"  // widen, store_as: f32 loads, one rounding store

namespace {

constexpr int kThreads = 256;

// v = Bᵀ d for one column of T values (Lavin & Gray's F(m,3) matrices,
// the reference's winograd.py::_BT).
template <int M>
struct Transform;

template <>
struct Transform<2> {
  static constexpr int T = 4;

  static __device__ __forceinline__ void bt(const float (&d)[T],
                                            float (&v)[T]) {
    v[0] = d[0] - d[2];
    v[1] = d[1] + d[2];
    v[2] = d[2] - d[1];
    v[3] = d[1] - d[3];
  }

  // y = Aᵀ m (_AT of F(2,3)).
  static __device__ __forceinline__ void at(const float (&m)[T],
                                            float (&y)[2]) {
    y[0] = m[0] + m[1] + m[2];
    y[1] = m[1] - m[2] - m[3];
  }
};

template <>
struct Transform<4> {
  static constexpr int T = 6;

  static __device__ __forceinline__ void bt(const float (&d)[T],
                                            float (&v)[T]) {
    v[0] = fmaf(4.f, d[0], fmaf(-5.f, d[2], d[4]));
    v[1] = fmaf(-4.f, d[1], fmaf(-4.f, d[2], d[3] + d[4]));
    v[2] = fmaf(4.f, d[1], fmaf(-4.f, d[2], d[4] - d[3]));
    v[3] = fmaf(-2.f, d[1], fmaf(2.f, d[3], d[4] - d[2]));
    v[4] = fmaf(2.f, d[1], fmaf(-2.f, d[3], d[4] - d[2]));
    v[5] = fmaf(4.f, d[1], fmaf(-5.f, d[3], d[5]));
  }

  static __device__ __forceinline__ void at(const float (&m)[T],
                                            float (&y)[4]) {
    const float s12 = m[1] + m[2], d12 = m[1] - m[2];
    const float s34 = m[3] + m[4], d34 = m[3] - m[4];
    y[0] = m[0] + s12 + s34;
    y[1] = fmaf(2.f, d34, d12);
    y[2] = fmaf(4.f, s34, s12);
    y[3] = fmaf(8.f, d34, d12) + m[5];
  }
};

// V[ξν] = (Bᵀ d B)[ξ][ν] for one tile held in registers, stored to
// v[(ξ·T + ν)·plane] (plane = n·C: the stride between intra-tile positions)
// rounded once to T.
template <int M, class T>
__device__ __forceinline__ void transform_and_store(
    const float (&d)[M + 2][M + 2], T* __restrict__ v, size_t plane) {
  constexpr int TT = M + 2;
  float tmp[TT][TT];  // tmp[ξ][j] = Σ_i Bᵀ[ξ][i] d[i][j]
#pragma unroll
  for (int j = 0; j < TT; ++j) {
    float col[TT], out[TT];
#pragma unroll
    for (int i = 0; i < TT; ++i) col[i] = d[i][j];
    Transform<M>::bt(col, out);
#pragma unroll
    for (int i = 0; i < TT; ++i) tmp[i][j] = out[i];
  }
#pragma unroll
  for (int xi = 0; xi < TT; ++xi) {
    float out[TT];
    Transform<M>::bt(tmp[xi], out);
#pragma unroll
    for (int nu = 0; nu < TT; ++nu)
      repro::store_as(v + (size_t)(xi * TT + nu) * plane, out[nu]);
  }
}

// x (B, H, W, C) NHWC -> V (T², B·tiles, C). Thread (b·tiles + tile, c)
// reads the window whose top-left padded pixel is (ty·m, tx·m), i.e. input
// pixel (ty·m - pad_top, tx·m - pad_left); pixels outside the map read 0.
template <int M, class T>
__device__ __forceinline__ void input_transform_body(
    const T* __restrict__ x, T* __restrict__ v, int batch, int h, int w,
    int c, int tiles_y, int tiles_x, int pad_top, int pad_left) {
  constexpr int TT = M + 2;
  const int per_image = tiles_y * tiles_x;
  const size_t n = (size_t)batch * per_image;
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n * c) return;
  const int ci = (int)(idx % c);
  const size_t nt = idx / c;  // b·tiles + tile
  const int b = (int)(nt / per_image);
  const int tile = (int)(nt - (size_t)b * per_image);
  const int ty = tile / tiles_x;
  const int y0 = ty * M - pad_top;
  const int x0 = (tile - ty * tiles_x) * M - pad_left;
  const T* __restrict__ xb = x + (size_t)b * h * w * c + ci;
  float d[TT][TT];
#pragma unroll
  for (int i = 0; i < TT; ++i) {
    const int iy = y0 + i;
    const bool row_ok = iy >= 0 && iy < h;
#pragma unroll
    for (int j = 0; j < TT; ++j) {
      const int ix = x0 + j;
      d[i][j] = (row_ok && ix >= 0 && ix < w)
                    ? repro::widen(xb[((size_t)iy * w + ix) * c])
                    : 0.f;
    }
  }
  transform_and_store<M>(d, v + nt * c + ci, n * c);
}

// tiles (n, T, T, C) -> V (T², n, C).
template <int M, class T>
__device__ __forceinline__ void input_transform_tiles_body(
    const T* __restrict__ tiles, T* __restrict__ v, int n_tiles, int c) {
  constexpr int TT = M + 2;
  const size_t n = (size_t)n_tiles;
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n * c) return;
  const int ci = (int)(idx % c);
  const size_t nt = idx / c;
  const T* __restrict__ src = tiles + nt * TT * TT * c + ci;
  float d[TT][TT];
#pragma unroll
  for (int i = 0; i < TT; ++i)
#pragma unroll
    for (int j = 0; j < TT; ++j)
      d[i][j] = repro::widen(src[(size_t)(i * TT + j) * c]);
  transform_and_store<M>(d, v + nt * c + ci, n * c);
}

// M (T², B·tiles, C) -> out (B, O1, O2, C): Y = Aᵀ M A per tile, then
// bias (widened) and ReLU in registers, one rounding store; only pixels
// inside (O1, O2) are stored.
template <int M, class T>
__device__ __forceinline__ void output_transform_body(
    const T* __restrict__ mm, const T* __restrict__ bias, T* __restrict__ out,
    int batch, int c, int tiles_y, int tiles_x, int o1, int o2, int relu) {
  constexpr int TT = M + 2;
  const int per_image = tiles_y * tiles_x;
  const size_t n = (size_t)batch * per_image;
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n * c) return;
  const int ci = (int)(idx % c);
  const size_t nt = idx / c;
  const int b = (int)(nt / per_image);
  const int tile = (int)(nt - (size_t)b * per_image);
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const T* __restrict__ src = mm + nt * c + ci;
  const size_t plane = n * c;
  float tmp[M][TT];  // tmp[a][ν] = Σ_ξ Aᵀ[a][ξ] M[ξ][ν]
#pragma unroll
  for (int nu = 0; nu < TT; ++nu) {
    float col[TT], y[M];
#pragma unroll
    for (int xi = 0; xi < TT; ++xi)
      col[xi] = repro::widen(src[(size_t)(xi * TT + nu) * plane]);
    Transform<M>::at(col, y);
#pragma unroll
    for (int a = 0; a < M; ++a) tmp[a][nu] = y[a];
  }
  const float bv = bias != nullptr ? repro::widen(bias[ci]) : 0.f;
  T* __restrict__ ob = out + (size_t)b * o1 * o2 * c + ci;
#pragma unroll
  for (int a = 0; a < M; ++a) {
    const int oy = ty * M + a;
    if (oy >= o1) continue;
    float y[M];
    Transform<M>::at(tmp[a], y);
#pragma unroll
    for (int e = 0; e < M; ++e) {
      const int ox = tx * M + e;
      if (ox >= o2) continue;
      float val = y[e] + bv;
      if (relu) val = val > 0.f ? val : 0.f;
      repro::store_as(ob + ((size_t)oy * o2 + ox) * c, val);
    }
  }
}

// The kernels: one __global__ name per element type.
template <int M>
__global__ void __launch_bounds__(kThreads)
    input_transform_kernel(const float* __restrict__ x,
                           float* __restrict__ v, int batch, int h, int w,
                           int c, int tiles_y, int tiles_x, int pad_top,
                           int pad_left) {
  input_transform_body<M>(x, v, batch, h, w, c, tiles_y, tiles_x, pad_top,
                          pad_left);
}

template <int M>
__global__ void __launch_bounds__(kThreads)
    input_transform_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                __nv_bfloat16* __restrict__ v, int batch,
                                int h, int w, int c, int tiles_y,
                                int tiles_x, int pad_top, int pad_left) {
  input_transform_body<M>(x, v, batch, h, w, c, tiles_y, tiles_x, pad_top,
                          pad_left);
}

template <int M>
__global__ void __launch_bounds__(kThreads)
    input_transform_tiles_kernel(const float* __restrict__ tiles,
                                 float* __restrict__ v, int n_tiles, int c) {
  input_transform_tiles_body<M>(tiles, v, n_tiles, c);
}

template <int M>
__global__ void __launch_bounds__(kThreads)
    input_transform_tiles_bf16_kernel(
        const __nv_bfloat16* __restrict__ tiles,
        __nv_bfloat16* __restrict__ v, int n_tiles, int c) {
  input_transform_tiles_body<M>(tiles, v, n_tiles, c);
}

template <int M>
__global__ void __launch_bounds__(kThreads)
    output_transform_kernel(const float* __restrict__ mm,
                            const float* __restrict__ bias,
                            float* __restrict__ out, int batch, int c,
                            int tiles_y, int tiles_x, int o1, int o2,
                            int relu) {
  output_transform_body<M>(mm, bias, out, batch, c, tiles_y, tiles_x, o1, o2,
                           relu);
}

template <int M>
__global__ void __launch_bounds__(kThreads)
    output_transform_bf16_kernel(const __nv_bfloat16* __restrict__ mm,
                                 const __nv_bfloat16* __restrict__ bias,
                                 __nv_bfloat16* __restrict__ out, int batch,
                                 int c, int tiles_y, int tiles_x, int o1,
                                 int o2, int relu) {
  output_transform_body<M>(mm, bias, out, batch, c, tiles_y, tiles_x, o1, o2,
                           relu);
}

inline unsigned blocks_for(size_t threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

}  // namespace

// V (T², B·tiles_y·tiles_x, C) = Bᵀ d B over the T x T windows (stride m)
// of x (B, H, W, C), read with (pad_top, pad_left) of zero halo and zero
// fill past the bottom/right edge. m is 2 or 4. All f32, contiguous, on the
// current device. Returns cudaGetLastError().
extern "C" int winograd_input_transform_f32(const void* x, void* v, int batch,
                                            int h, int w, int c, int m,
                                            int tiles_y, int tiles_x,
                                            int pad_top, int pad_left,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = blocks_for((size_t)batch * tiles_y * tiles_x * c);
  const float* xf = static_cast<const float*>(x);
  float* vf = static_cast<float*>(v);
  if (m == 2)
    input_transform_kernel<2><<<grid, kThreads, 0, s>>>(
        xf, vf, batch, h, w, c, tiles_y, tiles_x, pad_top, pad_left);
  else if (m == 4)
    input_transform_kernel<4><<<grid, kThreads, 0, s>>>(
        xf, vf, batch, h, w, c, tiles_y, tiles_x, pad_top, pad_left);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// V (T², n, C) = Bᵀ d B for each tile of tiles (n, T, T, C). m is 2 or 4.
extern "C" int winograd_input_transform_tiles_f32(const void* tiles, void* v,
                                                  int n_tiles, int c, int m,
                                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = blocks_for((size_t)n_tiles * c);
  const float* tf = static_cast<const float*>(tiles);
  float* vf = static_cast<float*>(v);
  if (m == 2)
    input_transform_tiles_kernel<2><<<grid, kThreads, 0, s>>>(tf, vf, n_tiles,
                                                              c);
  else if (m == 4)
    input_transform_tiles_kernel<4><<<grid, kThreads, 0, s>>>(tf, vf, n_tiles,
                                                              c);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// out (B, O1, O2, C) = epilogue(Aᵀ M A [+ bias]) for M (T², B·tiles, C),
// tile (ty, tx) of image b landing at rows ty·m.., cols tx·m.. and cropped
// to (O1, O2). bias (C,) may be NULL. m is 2 or 4.
extern "C" int winograd_output_transform_f32(const void* mm, const void* bias,
                                             void* out, int batch, int c,
                                             int m, int tiles_y, int tiles_x,
                                             int o1, int o2, int relu,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = blocks_for((size_t)batch * tiles_y * tiles_x * c);
  const float* mf = static_cast<const float*>(mm);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  if (m == 2)
    output_transform_kernel<2><<<grid, kThreads, 0, s>>>(
        mf, bf, of, batch, c, tiles_y, tiles_x, o1, o2, relu);
  else if (m == 4)
    output_transform_kernel<4><<<grid, kThreads, 0, s>>>(
        mf, bf, of, batch, c, tiles_y, tiles_x, o1, o2, relu);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The bf16 twins of the three entry points above: the same arguments, every
// tensor (the output transform's bias too) bf16, loads widened to f32, the
// transforms, bias and ReLU in f32, one round-to-nearest-even store.
extern "C" int winograd_input_transform_bf16(const void* x, void* v,
                                             int batch, int h, int w, int c,
                                             int m, int tiles_y, int tiles_x,
                                             int pad_top, int pad_left,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = blocks_for((size_t)batch * tiles_y * tiles_x * c);
  const __nv_bfloat16* xh = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* vh = static_cast<__nv_bfloat16*>(v);
  if (m == 2)
    input_transform_bf16_kernel<2><<<grid, kThreads, 0, s>>>(
        xh, vh, batch, h, w, c, tiles_y, tiles_x, pad_top, pad_left);
  else if (m == 4)
    input_transform_bf16_kernel<4><<<grid, kThreads, 0, s>>>(
        xh, vh, batch, h, w, c, tiles_y, tiles_x, pad_top, pad_left);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int winograd_input_transform_tiles_bf16(const void* tiles, void* v,
                                                   int n_tiles, int c, int m,
                                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = blocks_for((size_t)n_tiles * c);
  const __nv_bfloat16* th = static_cast<const __nv_bfloat16*>(tiles);
  __nv_bfloat16* vh = static_cast<__nv_bfloat16*>(v);
  if (m == 2)
    input_transform_tiles_bf16_kernel<2><<<grid, kThreads, 0, s>>>(
        th, vh, n_tiles, c);
  else if (m == 4)
    input_transform_tiles_bf16_kernel<4><<<grid, kThreads, 0, s>>>(
        th, vh, n_tiles, c);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int winograd_output_transform_bf16(const void* mm,
                                              const void* bias, void* out,
                                              int batch, int c, int m,
                                              int tiles_y, int tiles_x,
                                              int o1, int o2, int relu,
                                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = blocks_for((size_t)batch * tiles_y * tiles_x * c);
  const __nv_bfloat16* mh = static_cast<const __nv_bfloat16*>(mm);
  const __nv_bfloat16* bh = static_cast<const __nv_bfloat16*>(bias);
  __nv_bfloat16* oh = static_cast<__nv_bfloat16*>(out);
  if (m == 2)
    output_transform_bf16_kernel<2><<<grid, kThreads, 0, s>>>(
        mh, bh, oh, batch, c, tiles_y, tiles_x, o1, o2, relu);
  else if (m == 4)
    output_transform_bf16_kernel<4><<<grid, kThreads, 0, s>>>(
        mh, bh, oh, batch, c, tiles_y, tiles_x, o1, o2, relu);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
