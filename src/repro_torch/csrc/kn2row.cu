// kn2row convolution (§2.1.2) in IEEE f32, in bf16 and in int8: the K1·K2
// unit-conv GEMMs of phase 1 and the pad-and-accumulate of phase 2 with the
// fused flush.
//
// Replaces, in src/repro/kernels/kn2row/kn2row.py:
//   unit_conv_gemms  -> unit_conv_gemms_f32, unit_conv_gemms_bf16 for its
//                       bf16 path (f32 sums, bf16 p), and unit_conv_gemms_i8
//                       for its int8 path (exact int32 partials)
//   pad_accumulate   -> pad_accumulate_f32, pad_accumulate_bf16 for its bf16
//                       path (f32 sum of bf16 p, bf16 out), and
//                       pad_accumulate_i32 for its int8 path (int32 sum,
//                       then dequant → bias → ReLU → optional requant)
// On the main path (full-width Inception-v4) they run its 16 kn2row layers:
// the 3x3 stride-2 VALID reductions (stem/c4, stem/c5, redA/b2), the 1x1
// redA/b3a, and the 1x3 / 3x1 SAME convs of the Inception-C blocks, each
// as one launch of each kernel per layer per forward, with the batch folded
// into the GEMM's M. The bf16 forms run the same 16 layers of Inception-v4
// with bf16 params (init_params(dtype=bf16)).
//
// Layouts: x2d (M, Cin) with M = B·H·W (the NHWC map, flattened); w (G,
// Cin, Cout) with G = K1·K2 and g = k1·K2 + k2; p (G, B, H, W, Cout), the
// unit-conv products at full input resolution, as the reference computes
// them; out (B, O1, O2, Cout).
//
// What bounds them on an H100. Phase 1 is arithmetic: per row of x2d it
// does 2·G·Cin·Cout FLOP for 4·(Cin + G·Cout) bytes read and written, 30
// (stem/c4) to 170 (redA/b2) FLOP per byte on Inception-v4's layers, above
// the ~20 where 67 TFLOP/s of non-tensor-core f32 meets 3.35 TB/s. At stride 2
// it multiplies at full input resolution, as the reference does: ~4x the
// direct conv's multiplies on stem/c4. Phase 2 is bytes: G adds per output
// value, and it reads G of p's values per output (a quarter of p at stride
// 2) and writes the output once.
//
// What the design does about it. Phase 1 runs the f32 mainloop of gemm_f32
// (tile_gemm_async.cuh: two-stage cp.async buffer of 16-deep K chunks, one
// barrier per chunk, float4 shared-memory reads) with one grid layer per g,
// but A's pointer is the same for every g: the reference's "X block index
// map ignores g". Every g reads the same x2d, so its tiles are served from
// L2 when blocks of several g run together. It has no epilogue (bias and
// ReLU come after the sum), and ragged M/N/K edges are zero-filled: nothing
// is padded on the host (the reference pads x2d and w to its blocks). A
// grid with fewer blocks than the card has SMs (the Inception-C layers: 24
// blocks at batch 8, 3 at batch 1) splits K into S slices, grid z = g·S +
// s, each slice's raw partial in the workspace (S, G·M, Cout); then
// unit_conv_gemms_f32_reduce_kernel, launched by the same entry point on
// the same stream, sums the slices in the order s = 0, 1, … into p: the
// same bits on every call.
//
// Phase 2 streams p once and holds nothing for reuse: for one offset each
// value of p is read by at most one output, so there is no tile for shared
// memory or TMA to keep, and its time is the bytes it keeps in flight. A
// thread owns V = 4 consecutive channels of one output pixel (y, x), channel
// fastest: one 16-byte streaming load (ld.global.cs) of p per offset and one
// 16-byte store of the output, so a warp's load of one p_g row is 512
// consecutive bytes. For the (K1, K2) the planner gives the main paths (3x3,
// 1x3, 3x1, 1x1) the offsets are template parameters: the taps unroll into
// predicated loads with no branch between them, so loads run ahead of the
// adds (at 3x3 ptxas issues three 16-byte loads before the first add, 48
// bytes a thread, where a runtime loop with a branch per tap held one 4-byte
// load and waited on it). Any other K1 x K2 (a 1x7, a 5x5) runs the generic
// form, the same code with the offsets in a runtime loop; a C that is not a
// multiple of 4, or p or out off 16-byte alignment, runs V = 1 (the wrapper
// chooses: vec). Each thread decodes (b, y, x, channel) once in 32-bit
// arithmetic: the wrapper keeps every index below 2^31. The TPU kernel walks
// a grid over the offsets with the output resident in VMEM; here the loop
// over g = 0 … G-1 runs inside the thread with the sums in registers, in the
// plain version's order, a tap outside the map adding 0 as the plain
// version adds F.pad's zeros (so the f32 sums are the plain version's bits),
// and bias and ReLU are applied there before the single store. The
// reference zero-pads p on the host first (another write of p, ~620 MB at
// stem/c4 and batch 8); here a row or column outside [0, H) x [0, W) of the
// thread's own image is a predicate, so p is never padded and a SAME pad
// never reads the neighbouring image of the batch.
//
// The int8 forms. Phase 1 runs on the int8 tensor cores through
// tile_mma_i8.cuh (mma.sync m16n8k32 s8, cp.async double buffer), with
// blockIdx.z = g and one A for every g as in f32: it reads int8 x2d and w
// (a quarter of the f32 bytes), sums in int32 and writes exact int32 p
// with the f32 layout (p is as large as in f32: 597 MB at stem/c4, batch
// 8, so the store of p bounds it); no scale is applied there, since the
// per-channel scale is the same for every offset. Phase 2 sums the int32
// offsets in registers (exact, so any order gives the same sum) and
// applies tile_gemm.cuh's dequant_epilogue and requantize per lane before
// its single store of 4 lanes, f32 (16 bytes) or int8 (4 bytes). On the
// gated Inception-v4 path they run its 15 int8 kn2row layers.
//
// The bf16 forms (the reference's kernels are dtype-generic: phase 1 sums
// in f32 and stores p in x's dtype, phase 2 sums p in f32 and stores p's
// dtype). Phase 1 runs tile_mma_bf16.cuh's mma.sync loop (m16n8k16 bf16,
// f32 accumulators), as batched_gemm_bf16 does, with blockIdx.z = g and one
// A for every g: p[g] = x2d · w[g] rounded once to nearest even at the store
// (CastFlush, no bias, no ReLU), half the bytes of the f32 p. K is not
// split: the bf16 loop has no split-K form yet (a grid smaller than the
// card, the Inception-C layers at small batches, runs as it is). Phase 2 is
// the f32 kernel's body on bf16 p: each tap's V = 4 channels come in one
// 8-byte streaming load, widened to f32, summed in the order g = 0 … G-1;
// bias (bf16, widened) and ReLU in f32, then one __float2bfloat16_rn store
// per value, 8 bytes for V = 4. It has its own __global__, so a profile
// names it apart from the f32 and int32 kernels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_gemm.cuh"
#include "tile_gemm_async.cuh"
#include "tile_mma_bf16.cuh"
#include "tile_mma_i8.cuh"

namespace {

constexpr int kAccThreads = 256;

// Offset g = blockIdx.z / splits, K slice s = blockIdx.z % splits: the
// whole product into p[g] when splits is 1, else the slice's raw partial
// into work[s] (G·M, N) at rows g·M.
template <int BM, int BN>
__global__ void __launch_bounds__(repro::kThreads)
    unit_conv_gemms_f32_kernel(const float* __restrict__ x,
                               const float* __restrict__ w,
                               float* __restrict__ p, float* __restrict__ work,
                               int m, int n, int k, int splits, int vec) {
  const size_t g = blockIdx.z / splits;
  const int s = blockIdx.z % splits;
  // The same A (x2d) for every g; w offset by g.
  const float* wg = w + g * k * n;
  const repro::DenseA src{x, m, k};
  if (splits == 1) {
    repro::tile_gemm_async<BM, BN>(
        src, wg, repro::F32Flush{nullptr, p + g * m * n, n, 0}, m, n, 0, k,
        vec);
    return;
  }
  const size_t groups = gridDim.z / splits;
  const int depth = repro::slice_depth(k, splits);
  repro::tile_gemm_async<BM, BN>(
      src, wg, repro::RawF32Flush{work + (s * groups + g) * m * n, n}, m, n,
      s * depth, min(k, (s + 1) * depth), vec);
}

__global__ void __launch_bounds__(repro::kReduceThreads)
    unit_conv_gemms_f32_reduce_kernel(const float* __restrict__ work,
                                      float* __restrict__ p, long long total,
                                      int n, int splits) {
  repro::reduce_slices(work, nullptr, p, total, n, splits, 0);
}

template <int BM, int BN>
__global__ void __launch_bounds__(repro::kThreads)
    unit_conv_gemms_i8_kernel(const int8_t* __restrict__ x,
                              const int8_t* __restrict__ w,
                              int* __restrict__ p, int m, int n, int k,
                              int vec) {
  const size_t g = blockIdx.z;
  // The same A (x2d) for every g; w and p offset by g.
  repro::tile_mma_i8_flush<BM, BN>(repro::DenseI8{x, m, k}, w + g * k * n,
                                   repro::RawI32Flush{p + g * m * n, n}, m,
                                   n, k, vec);
}

// Offset g = blockIdx.z of the bf16 product: the same A (x2d) for every g,
// w and p offset by g; the f32 sum rounded once into p. The entry point
// takes the 16-byte path only when it holds for every g.
template <int BM, int BN>
__global__ void __launch_bounds__(repro::kThreads)
    unit_conv_gemms_bf16_kernel(const uint16_t* __restrict__ x,
                                const uint16_t* __restrict__ w,
                                __nv_bfloat16* __restrict__ p, int m, int n,
                                int k, int vec) {
  const size_t g = blockIdx.z;
  repro::tile_mma_bf16_flush<BM, BN>(
      repro::DenseBf16{x, m, k}, w + g * k * n,
      repro::CastFlush<__nv_bfloat16, __nv_bfloat16>{nullptr, p + g * m * n,
                                                     n, 0},
      m, n, k, vec);
}

// The geometry of one pad-and-accumulate: p (k1·k2, batch, h, w, c), out
// (batch, o1, o2, c). Every index into p or out is below 2^31, as the
// wrapper checks, so the kernels index in 32 bits.
struct AccGeom {
  int batch, h, w, c, k1, k2, o1, o2, stride, pad_top, pad_left;
};

// V consecutive channels of p at `src`, read once (a streaming load): one
// 16-byte load for V = 4, or 0 for a tap outside the map.
__device__ __forceinline__ void load_lanes(const float* src, float (&v)[4]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(src));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load_lanes(const int* src, int (&v)[4]) {
  const int4 q = __ldcs(reinterpret_cast<const int4*>(src));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// Four bf16 channels in one 8-byte load, widened exactly to f32 (a bf16
// value is the upper half of its f32).
__device__ __forceinline__ void load_lanes(const __nv_bfloat16* src,
                                           float (&v)[4]) {
  const uint2 q = __ldcs(reinterpret_cast<const uint2*>(src));
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

// One value of p as its sum's type: bf16 widened exactly to f32.
__device__ __forceinline__ float as_sum(float v) { return v; }
__device__ __forceinline__ int as_sum(int v) { return v; }
__device__ __forceinline__ float as_sum(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <class T, class A>
__device__ __forceinline__ void load_lanes(const T* src, A (&v)[1]) {
  v[0] = as_sum(__ldcs(src));
}

template <class T, class A, int V>
__device__ __forceinline__ void tap(const T* src, bool in, A (&v)[V]) {
  if (in) {
    load_lanes(src, v);
  } else {
#pragma unroll
    for (int l = 0; l < V; ++l) v[l] = A(0);
  }
}

// One thread owns V consecutive channels of one output pixel, channel
// fastest, so output element o = V · thread index. It sums p's K1·K2
// offsets in the order g = 0 … G-1 (in as_sum's type: bf16 p in f32), a
// tap outside its own image's (h, w) map adding 0, as the plain version
// adds F.pad's zeros, and hands the sums to flush(o, first channel, acc).
// With K1 and K2 known (K1 > 0) the taps unroll into predicated loads, all
// issued before the adds in program order; K1 = K2 = 0 is the generic
// form, a loop over the geometry's k1 x k2.
template <int K1, int K2, int V, class T, class Flush>
__device__ __forceinline__ void pad_accumulate(const T* __restrict__ p,
                                               const AccGeom& g,
                                               const Flush& flush) {
  // (b, oy, ox, channel vector) of thread i: three 32-bit divisions.
  const unsigned vecs = g.c / V;  // channel vectors per pixel
  const unsigned i = blockIdx.x * kAccThreads + threadIdx.x;
  const unsigned pix = i / vecs;
  const unsigned row = pix / g.o2;  // b · o1 + oy
  const unsigned b = row / g.o1;
  if (b >= (unsigned)g.batch) return;
  const unsigned ox = pix - row * g.o2;
  const unsigned oy = row - b * g.o1;
  const int ch = (i - pix * vecs) * V;
  const int y0 = g.stride * (int)oy - g.pad_top;
  const int x0 = g.stride * (int)ox - g.pad_left;
  const int plane = g.batch * g.h * g.w * g.c;  // one offset's p_g
  const T* __restrict__ img = p + (int)b * g.h * g.w * g.c + ch;

  using A = decltype(as_sum(*p));  // the sums' type: f32, or int32
  A acc[V];
  if constexpr (K1 > 0) {
    A v[K1 * K2][V];
#pragma unroll
    for (int dk1 = 0; dk1 < K1; ++dk1) {
#pragma unroll
      for (int dk2 = 0; dk2 < K2; ++dk2) {
        const int y = y0 + dk1, x = x0 + dk2;
        const bool in =
            (unsigned)y < (unsigned)g.h && (unsigned)x < (unsigned)g.w;
        tap(img + (dk1 * K2 + dk2) * plane + (in ? (y * g.w + x) * g.c : 0),
            in, v[dk1 * K2 + dk2]);
      }
    }
#pragma unroll
    for (int l = 0; l < V; ++l) {
      acc[l] = v[0][l];
#pragma unroll
      for (int j = 1; j < K1 * K2; ++j) acc[l] += v[j][l];
    }
  } else {
    for (int dk1 = 0, j = 0; dk1 < g.k1; ++dk1) {
      for (int dk2 = 0; dk2 < g.k2; ++dk2, ++j) {
        const int y = y0 + dk1, x = x0 + dk2;
        const bool in =
            (unsigned)y < (unsigned)g.h && (unsigned)x < (unsigned)g.w;
        A v[V];
        tap(img + j * plane + (in ? (y * g.w + x) * g.c : 0), in, v);
#pragma unroll
        for (int l = 0; l < V; ++l) acc[l] = j == 0 ? v[l] : acc[l] + v[l];
      }
    }
  }
  flush((int)i * V, ch, acc);
}

// f32 flush of V lanes: bias and ReLU per lane, then one store (16 bytes
// for V = 4).
struct F32Lanes {
  const float* __restrict__ bias;
  float* __restrict__ out;
  int relu;

  template <int V>
  __device__ __forceinline__ void operator()(int o, int ch,
                                             float (&acc)[V]) const {
#pragma unroll
    for (int l = 0; l < V; ++l) {
      if (bias != nullptr) acc[l] += bias[ch + l];
      if (relu) acc[l] = acc[l] > 0.f ? acc[l] : 0.f;
    }
    if constexpr (V == 4)
      *reinterpret_cast<float4*>(out + o) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    else
      out[o] = acc[0];
  }
};

// bf16 flush of V f32 sums: bias widened and ReLU per lane in f32, then
// one round-to-nearest-even store (8 bytes for V = 4).
struct Bf16Lanes {
  const __nv_bfloat16* __restrict__ bias;
  __nv_bfloat16* __restrict__ out;
  int relu;

  template <int V>
  __device__ __forceinline__ void operator()(int o, int ch,
                                             float (&acc)[V]) const {
#pragma unroll
    for (int l = 0; l < V; ++l) {
      if (bias != nullptr)
        acc[l] = __fadd_rn(acc[l], repro::widen(bias[ch + l]));
      if (relu) acc[l] = acc[l] > 0.f ? acc[l] : 0.f;
    }
    if constexpr (V == 4) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[0], acc[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[2], acc[3]);
      *reinterpret_cast<uint2*>(out + o) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                     *reinterpret_cast<const uint32_t*>(&hi));
    } else {
      out[o] = __float2bfloat16_rn(acc[0]);
    }
  }
};

// The quantized flush of V exact int32 sums: tile_gemm.cuh's
// dequant_epilogue (and requantize for an int8 output) per lane, then one
// store: a float4, or 4 bytes of int8, for V = 4.
struct QuantLanes {
  const float* __restrict__ scale;
  const float* __restrict__ bias;
  float* __restrict__ out_f;
  int8_t* __restrict__ out_q;
  float out_scale;
  int relu;

  template <int V>
  __device__ __forceinline__ void operator()(int o, int ch,
                                             const int (&acc)[V]) const {
    float v[V];
#pragma unroll
    for (int l = 0; l < V; ++l)
      v[l] = repro::dequant_epilogue(acc[l], scale[ch + l], bias, ch + l,
                                     relu);
    if (out_q != nullptr) {
      if constexpr (V == 4)
        *reinterpret_cast<char4*>(out_q + o) = make_char4(
            repro::requantize(v[0], out_scale),
            repro::requantize(v[1], out_scale),
            repro::requantize(v[2], out_scale),
            repro::requantize(v[3], out_scale));
      else
        out_q[o] = repro::requantize(v[0], out_scale);
    } else {
      if constexpr (V == 4)
        *reinterpret_cast<float4*>(out_f + o) =
            make_float4(v[0], v[1], v[2], v[3]);
      else
        out_f[o] = v[0];
    }
  }
};

template <int K1, int K2, int V>
__global__ void __launch_bounds__(kAccThreads)
    pad_accumulate_f32_kernel(const float* __restrict__ p, F32Lanes flush,
                              AccGeom g) {
  pad_accumulate<K1, K2, V>(p, g, flush);
}

template <int K1, int K2, int V>
__global__ void __launch_bounds__(kAccThreads)
    pad_accumulate_bf16_kernel(const __nv_bfloat16* __restrict__ p,
                               Bf16Lanes flush, AccGeom g) {
  pad_accumulate<K1, K2, V>(p, g, flush);
}

template <int K1, int K2, int V>
__global__ void __launch_bounds__(kAccThreads)
    pad_accumulate_i32_kernel(const int* __restrict__ p, QuantLanes flush,
                              AccGeom g) {
  pad_accumulate<K1, K2, V>(p, g, flush);
}

// An entry point's launch: run<K1, K2, V>(blocks) enqueues its kernel's
// instantiation on one thread per V channels of an output pixel.
struct F32Launch {
  const float* p;
  F32Lanes flush;
  AccGeom g;
  cudaStream_t s;

  template <int K1, int K2, int V>
  void run(unsigned blocks) const {
    pad_accumulate_f32_kernel<K1, K2, V><<<blocks, kAccThreads, 0, s>>>(
        p, flush, g);
  }
};

struct Bf16Launch {
  const __nv_bfloat16* p;
  Bf16Lanes flush;
  AccGeom g;
  cudaStream_t s;

  template <int K1, int K2, int V>
  void run(unsigned blocks) const {
    pad_accumulate_bf16_kernel<K1, K2, V><<<blocks, kAccThreads, 0, s>>>(
        p, flush, g);
  }
};

struct I32Launch {
  const int* p;
  QuantLanes flush;
  AccGeom g;
  cudaStream_t s;

  template <int K1, int K2, int V>
  void run(unsigned blocks) const {
    pad_accumulate_i32_kernel<K1, K2, V><<<blocks, kAccThreads, 0, s>>>(
        p, flush, g);
  }
};

// The offsets unrolled: 3x3, 1x3, 3x1 and 1x1, the (K1, K2) of every
// kn2row layer the planner gives the main paths (kernels/kn2row/kn2row.py
// UNROLLED_OFFSETS lists the same); any other K1 x K2 runs the generic
// form <0, 0, V>.
template <int V, class Launch>
void dispatch_offsets(const Launch& launch) {
  const AccGeom& g = launch.g;
  const long long threads = (long long)g.batch * g.o1 * g.o2 * (g.c / V);
  const unsigned blocks =
      (unsigned)((threads + kAccThreads - 1) / kAccThreads);
  if (g.k1 == 3 && g.k2 == 3)
    launch.template run<3, 3, V>(blocks);
  else if (g.k1 == 1 && g.k2 == 3)
    launch.template run<1, 3, V>(blocks);
  else if (g.k1 == 3 && g.k2 == 1)
    launch.template run<3, 1, V>(blocks);
  else if (g.k1 == 1 && g.k2 == 1)
    launch.template run<1, 1, V>(blocks);
  else
    launch.template run<0, 0, V>(blocks);
}

// V = 4 when vec is nonzero, else 1. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a vector path the operands do not allow: p and
// out must lie on 4 of p's elements (16 bytes, or 8 for bf16 p).
template <class Launch>
int dispatch_accumulate(const Launch& launch, const void* out, int vec) {
  if (vec) {
    const uintptr_t align = 4 * sizeof(*launch.p);
    if (launch.g.c % 4 != 0 ||
        reinterpret_cast<uintptr_t>(launch.p) % align ||
        reinterpret_cast<uintptr_t>(out) % align)
      return (int)cudaErrorInvalidValue;
    dispatch_offsets<4>(launch);
  } else {
    dispatch_offsets<1>(launch);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// p (groups, m, n) = x (m, k) · w[g] (k, n) for g < groups: one A shared by
// every g, no epilogue; all f32, contiguous, on the current device, p
// 16-byte aligned. (tile_m, tile_n) must be an instantiated tile: 64 or 128
// each. K is cut into `splits` slices (slice_depth); with splits > 1, work
// is the f32 workspace (splits, groups·m, n) and a second kernel on the
// same stream sums the slices in order into p. vec: n % 4 == 0 and w
// 16-byte aligned. Returns cudaGetLastError().
extern "C" int unit_conv_gemms_f32(const void* x, const void* w, void* p,
                                   void* work, int groups, int m, int n,
                                   int k, int tile_m, int tile_n, int splits,
                                   int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_TILE(unit_conv_gemms_f32_kernel, tile_m, tile_n, m, n,
                      groups * splits, st, static_cast<const float*>(x),
                      static_cast<const float*>(w), static_cast<float*>(p),
                      static_cast<float*>(work), m, n, k, splits, vec);
  const int err = (int)cudaGetLastError();
  if (err != 0 || splits == 1) return err;
  const long long total = (long long)groups * m * n;
  unit_conv_gemms_f32_reduce_kernel<<<repro::reduce_blocks(total, n),
                                      repro::kReduceThreads, 0, st>>>(
      static_cast<const float*>(work), static_cast<float*>(p), total, n,
      splits);
  return (int)cudaGetLastError();
}

// p (groups, m, n) = x (m, k) · w[g] (k, n) for g < groups with x, w and p
// bf16, the sum in f32 on the tensor cores, rounded once to nearest even
// into p: one A shared by every g, no epilogue; all contiguous, on the
// current device. (tile_m, tile_n) must be an instantiated tile: 64 or 128
// each. K is not split. The 16-byte path is taken when it holds for every
// g: bf16_vector_path(x, w) and n % 8 == 0 (w[g] and p[g] move by
// multiples of 16 bytes); else the element path. Returns
// cudaGetLastError().
extern "C" int unit_conv_gemms_bf16(const void* x, const void* w, void* p,
                                    int groups, int m, int n, int k,
                                    int tile_m, int tile_n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = (int)(repro::bf16_vector_path(x, w, n, k) && n % 8 == 0);
  REPRO_DISPATCH_TILE(unit_conv_gemms_bf16_kernel, tile_m, tile_n, m, n,
                      groups, s, static_cast<const uint16_t*>(x),
                      static_cast<const uint16_t*>(w),
                      static_cast<__nv_bfloat16*>(p), m, n, k, vec);
  return (int)cudaGetLastError();
}

// p (groups, m, n) = x (m, k) · w[g] (k, n) for g < groups with x and w
// int8 and p the exact int32 sums: one A shared by every g, no epilogue;
// all contiguous, on the current device; the caller keeps k · 127² < 2^31.
// (tile_m, tile_n) must be an instantiated tile: 64 or 128 each. Returns
// cudaGetLastError().
extern "C" int unit_conv_gemms_i8(const void* x, const void* w, void* p,
                                  int groups, int m, int n, int k,
                                  int tile_m, int tile_n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_TILE(unit_conv_gemms_i8_kernel, tile_m, tile_n, m, n,
                      groups, s, static_cast<const int8_t*>(x),
                      static_cast<const int8_t*>(w), static_cast<int*>(p), m,
                      n, k, (int)repro::i8_vector_path(x, w, n, k));
  return (int)cudaGetLastError();
}

// out (batch, o1, o2, c) = epilogue(Σ_g p[g, b, S·y + k1 - pad_top,
// S·x + k2 - pad_left, c] [+ bias (c)]) over g = k1·K2 + k2 < K1·K2, rows
// and columns outside the (h, w) map counting as 0; p (K1·K2, batch, h, w,
// c), all f32, contiguous, on the current device, every index into p and
// out below 2^31. bias may be NULL. vec: c % 4 == 0 and p and out 16-byte
// aligned (4 channels a thread). Returns cudaGetLastError().
extern "C" int pad_accumulate_f32(const void* p, const void* bias, void* out,
                                  int batch, int h, int w, int c, int k1,
                                  int k2, int o1, int o2, int stride,
                                  int pad_top, int pad_left, int relu,
                                  int vec, void* stream) {
  const F32Launch launch{
      static_cast<const float*>(p),
      F32Lanes{static_cast<const float*>(bias), static_cast<float*>(out),
               relu},
      AccGeom{batch, h, w, c, k1, k2, o1, o2, stride, pad_top, pad_left},
      static_cast<cudaStream_t>(stream)};
  return dispatch_accumulate(launch, out, vec);
}

// out (batch, o1, o2, c) = epilogue(Σ_g p[g, b, S·y + k1 - pad_top,
// S·x + k2 - pad_left, c] [+ bias (c)]) for bf16 p (K1·K2, batch, h, w, c):
// the sum in f32 over g = k1·K2 + k2 < K1·K2 in order, rows and columns
// outside the (h, w) map counting as 0, bias (bf16, may be NULL) widened
// and ReLU in f32, out bf16 rounded once to nearest even; all contiguous,
// on the current device, every index into p and out below 2^31. vec:
// c % 4 == 0 and p and out 8-byte aligned (4 channels a thread). Returns
// cudaGetLastError().
extern "C" int pad_accumulate_bf16(const void* p, const void* bias, void* out,
                                   int batch, int h, int w, int c, int k1,
                                   int k2, int o1, int o2, int stride,
                                   int pad_top, int pad_left, int relu,
                                   int vec, void* stream) {
  const Bf16Launch launch{
      static_cast<const __nv_bfloat16*>(p),
      Bf16Lanes{static_cast<const __nv_bfloat16*>(bias),
                static_cast<__nv_bfloat16*>(out), relu},
      AccGeom{batch, h, w, c, k1, k2, o1, o2, stride, pad_top, pad_left},
      static_cast<cudaStream_t>(stream)};
  return dispatch_accumulate(launch, out, vec);
}

// out (batch, o1, o2, c) = flush(Σ_g p[g, b, S·y + k1 - pad_top,
// S·x + k2 - pad_left, c]) over g = k1·K2 + k2 < K1·K2 for int32 p
// (K1·K2, batch, h, w, c), the sum in int32, rows and columns outside the
// (h, w) map counting as 0; the flush is v = (float)sum · scale[c]
// [+ bias[c]] [ReLU], stored as f32, or, when requant is nonzero, as int8:
// clamp(round-half-even(v / out_scale), ±127). scale (c) f32; bias may be
// NULL; all contiguous, on the current device, every index into p and out
// below 2^31. vec: c % 4 == 0 and p and out 16-byte aligned (4 channels a
// thread). Returns cudaGetLastError().
extern "C" int pad_accumulate_i32(const void* p, const void* scale,
                                  const void* bias, void* out, int batch,
                                  int h, int w, int c, int k1, int k2, int o1,
                                  int o2, int stride, int pad_top,
                                  int pad_left, int relu, int requant,
                                  float out_scale, int vec, void* stream) {
  const I32Launch launch{
      static_cast<const int*>(p),
      QuantLanes{static_cast<const float*>(scale),
                 static_cast<const float*>(bias),
                 requant ? nullptr : static_cast<float*>(out),
                 requant ? static_cast<int8_t*>(out) : nullptr, out_scale,
                 relu},
      AccGeom{batch, h, w, c, k1, k2, o1, o2, stride, pad_top, pad_left},
      static_cast<cudaStream_t>(stream)};
  return dispatch_accumulate(launch, out, vec);
}
