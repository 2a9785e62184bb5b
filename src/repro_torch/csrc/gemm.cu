// Dataflow-bound tiled GEMM with the fused bias/ReLU flush, IEEE f32, its
// batched form, and its int8 form with the fused quantized flush.
//
// gemm_f32 replaces src/repro/kernels/gemm/gemm.py::gemm_pallas, the TPU
// Computing Unit on the MXU. On the main path it runs every conv whose
// input edge already carries its Toeplitz matrix
// (kernels/gemm/ops.py::toeplitz_gemm), with the batch folded into M so
// one launch covers a layer for the whole batch.
//
// batched_gemm_f32 replaces gemm.py::batched_gemm_pallas: G independent
// products C[g] = A[g] · B[g], the (m+r-1)^2 transform-space GEMMs of a
// Winograd layer (kernels/winograd/ops.py). Each block takes its problem
// from blockIdx.z and offsets A, B and C by g·M·K, g·K·N and g·M·N; the
// optional (N,) bias is shared by every g, as in the reference. On the
// Winograd path it runs without an epilogue (bias and ReLU fuse into the
// output transform) and with M = B·tiles, the batch folded into the tiles.
//
// What bounds it on an H100: arithmetic, for most main-path layers. The
// card's 67 TFLOP/s of non-tensor-core f32 meets its 3.35 TB/s of HBM at
// ~20 FLOP per byte; conv2 at batch 8 (M = 25088, K = 576, N = 192) does
// ~72 FLOP per byte of operands, and only layers with a narrow N (32, 48,
// 64 channels on 7x7 maps) fall below the ridge. The batched GEMM of a
// Winograd layer does 2·K·N / (4·(K + N)) FLOP per byte per row of A and C:
// ~16 for VGG16's conv0_1 (K = N = 64, bytes-bound) and ~64 for conv2_x
// (K = N = 256, operations-bound). Both kernels compute in IEEE f32 FMA
// (not TF32) so they match the reference at 1e-4, which rules out the
// tensor cores.
//
// What the design does about it. Both run tile_gemm_async.cuh with dense A
// (DenseA): a 128 x 128 (or 64-edge) output tile per 256-thread block with
// an 8 x 8 register micro-tile read from shared memory as float4, K in
// 16-deep chunks through a two-stage cp.async buffer (the copies of chunk
// c+1 in flight during chunk c's FMAs, one barrier per chunk); bias and ReLU
// are applied in registers before the single store; ragged M/N/K edges are
// zero-filled in the kernel instead of padding operands on the host. The TPU
// kernel carries the K sum across a sequential grid axis in VMEM; here
// blocks run in parallel and in no order, so a gemm_f32 grid with fewer
// blocks than the card has SMs (most main-path layers at small buckets: a
// 7x7 map is one tile row) splits K into S slices (grid z = s, S from
// kernels/gemm/gemm.py::split_k). Each slice writes its raw partial into the
// workspace (S, m, n) and gemm_f32_reduce_kernel, launched by the same entry
// point on the same stream, sums the slices in the order s = 0, 1, … and
// applies bias and ReLU: the same bits on every call. batched_gemm_f32 runs
// the same loop on each g's operands and never splits K: the main path's
// smallest batched grids (36 blocks) have 4-6 chunks of K, fewer than two
// slices of split_k's minimum depth. No wgmma or TF32: IEEE fmaf holds the
// reference's 1e-4.
//
// gemm_i8 is gemm_pallas's int8 path (_gemm_kernel with has_scale /
// out_scale and its int32 scratch): int8 A and B, the sum exact in int32,
// and the flush dequant (· scale[n], the per-channel in_scale · w_scale) →
// bias → ReLU → optionally requantize to int8 at the consumer's
// out_scale. On the main path (gated Inception-v4) it runs every int8
// layer whose input edge carries its Toeplitz matrix. Bound: bytes at
// the main path's shapes (redA/b3b does ~290 int8 operations per byte
// moved, below the ~590 where 1,979 TOPS of int8 tensor cores meet
// 3.35 TB/s). Design: tile_mma_i8.cuh, the mma.sync m16n8k32 s8 loop with
// a two-stage cp.async buffer of 64-deep K chunks, shared with
// unit_conv_gemms_i8 and conv_im2col_i8 (dense A here: DenseI8); no
// split-K or wgmma yet, so a small grid still walks K serially.
// Exactness: the int32 sum is the same integer in any order, and each
// flush step is one IEEE-rounded operation in torch's order, so it equals
// its plain version bit for bit.
//
// gemm_bf16 is gemm_pallas's bf16 path (bf16 A and B, the f32 VMEM
// accumulator, the flush's bias add and ReLU in f32 and one cast to the
// output dtype, gemm.py:96-99). On the main path (GoogleNet, VGG16 and
// Inception-v4 served in bf16) it runs every conv whose input edge carries
// its Toeplitz matrix: 56 of GoogleNet's 57 convs under elision, 116 of
// Inception-v4's. Bound: operations at the large layers (conv2 at batch 8,
// M = 25088, K = 576, N = 192, does ~150 FLOP per byte moved, against the
// ~295 where 989 TFLOP/s of bf16 tensor cores meet 3.35 TB/s, so bytes
// there too); the 7x7 and 8x8 layers at small buckets are bytes- and
// latency-bound, and their grids are a few blocks. Design: operands whose
// rows TMA can address (k % 8 == 0, n % 8 == 0, 16-byte aligned A and B:
// every main-path launch) run tile_wgmma_bf16.cuh, a four-stage TMA ring of
// 64-deep K chunks feeding wgmma m64nNk16 (B read MN-major from its
// swizzled stage, one producer warp, one or two consumer warpgroups) and a
// flush staged through shared memory into 16-byte stores. Any other
// operand runs tile_mma_bf16.cuh's mma.sync loop (gemm_bf16_mma: the int8
// loop's two-stage cp.async buffer with 16-bit elements, 32-deep chunks,
// dense A through DenseBf16, K not split: no main-path operand takes it).
// The entry point picks the loop by shape and alignment alone
// (wgmma_path), never on a failure. The wgmma loop splits K as gemm_f32
// does when the grid has fewer blocks than the card has SMs
// (kernels/gemm/gemm.py::grid_splits at its 64-deep chunks): slice s
// writes its raw f32 partial into the workspace and gemm_bf16_reduce_kernel
// (or its out_f32 twin) sums the slices in the order s = 0, 1, …, widens
// the bias, applies ReLU and rounds once to C's dtype. The f32 kernels take
// a bf16 C the same way (out_bf16: CastFlush<float, bf16> in the flush and
// in the split-K reduce), a store of the flush and never a second pass.
//
// batched_gemm_bf16 is batched_gemm_pallas's bf16 path (bf16 A[g] and B[g],
// the f32 VMEM accumulator, out_dtype = a.dtype): the Winograd layers of a
// bf16 model (full-width VGG16's five F(4,3) layers: G 36, M = B·tiles, K =
// Cin, N = Cout; Inception-v4's sixteen). It runs gemm_bf16's loops, g the
// tensor maps' third coordinate (blockIdx.z) on the wgmma loop and an
// offset of A, B and C on the mma.sync loop: f32 sums on the tensor
// cores, bias and ReLU in f32, one rounding at the flush. Bound: bytes at
// conv0_1 (K = N = 64: ~32 FLOP per byte moved) and at conv2_x (K = N =
// 256: ~128), both below bf16's ~295. No split K, as the reference has
// none: G·M fills the card at VGG16's shapes at every bucket (the smallest
// grid, conv2_x at bucket 1, M 196 and N 256, is 36 x 2 x 2 = 144 blocks
// of 128 x 128).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

#include "tile_gemm.cuh"
#include "tile_gemm_async.cuh"
#include "tile_mma_bf16.cuh"
#include "tile_mma_i8.cuh"
#include "tile_wgmma_bf16.cuh"

namespace {

// K slice blockIdx.z of gridDim.z: the whole product through `flush`
// when the grid has one slice, else the slice's raw partial into
// work[blockIdx.z] (m, n).
template <int BM, int BN, class Flush>
__device__ __forceinline__ void gemm_f32_tile(const float* __restrict__ a,
                                              const float* __restrict__ b,
                                              const Flush& flush,
                                              float* __restrict__ work, int m,
                                              int n, int k, int vec) {
  const int splits = gridDim.z;
  const repro::DenseA src{a, m, k};
  if (splits == 1) {
    repro::tile_gemm_async<BM, BN>(src, b, flush, m, n, 0, k, vec);
    return;
  }
  const int s = blockIdx.z;
  const int depth = repro::slice_depth(k, splits);
  repro::tile_gemm_async<BM, BN>(
      src, b, repro::RawF32Flush{work + (size_t)s * m * n, n}, m, n,
      s * depth, min(k, (s + 1) * depth), vec);
}

template <int BM, int BN>
__global__ void __launch_bounds__(repro::kThreads)
    gemm_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ bias, float* __restrict__ c,
                    float* __restrict__ work, int m, int n, int k, int relu,
                    int vec) {
  gemm_f32_tile<BM, BN>(a, b, repro::F32Flush{bias, c, n, relu}, work, m, n,
                        k, vec);
}

// The same with a bf16 C (out_dtype=bf16).
template <int BM, int BN>
__global__ void __launch_bounds__(repro::kThreads)
    gemm_f32_out_bf16_kernel(const float* __restrict__ a,
                             const float* __restrict__ b,
                             const float* __restrict__ bias,
                             __nv_bfloat16* __restrict__ c,
                             float* __restrict__ work, int m, int n, int k,
                             int relu, int vec) {
  gemm_f32_tile<BM, BN>(
      a, b, repro::CastFlush<float, __nv_bfloat16>{bias, c, n, relu}, work,
      m, n, k, vec);
}

__global__ void __launch_bounds__(repro::kReduceThreads)
    gemm_f32_reduce_kernel(const float* __restrict__ work,
                           const float* __restrict__ bias,
                           float* __restrict__ c, long long total, int n,
                           int splits, int relu) {
  repro::reduce_slices(work, bias, c, total, n, splits, relu);
}

__global__ void __launch_bounds__(repro::kReduceThreads)
    gemm_f32_out_bf16_reduce_kernel(const float* __restrict__ work,
                                    const float* __restrict__ bias,
                                    __nv_bfloat16* __restrict__ c,
                                    long long total, int n, int splits,
                                    int relu) {
  repro::reduce_slices_into(
      work, repro::CastFlush<float, __nv_bfloat16>{bias, c, n, relu}, total,
      n, splits);
}

template <int BM, int BN>
__global__ void __launch_bounds__(repro::kThreads)
    gemm_i8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                   repro::QuantFlush flush, int m, int n, int k, int vec) {
  repro::tile_mma_i8_flush<BM, BN>(repro::DenseI8{a, m, k}, b, flush, m, n,
                                   k, vec);
}

// Problem g = blockIdx.z: the async loop on A[g], B[g] and C[g]. With
// n % 4 == 0 every g·K·N and g·M·N is a multiple of 4 elements, so when B
// and C are aligned so is each B[g] and C[g]: the 16-byte B copies (vec)
// and flush4 hold for every g.
template <int BM, int BN, class Flush>
__device__ __forceinline__ void batched_gemm_f32_tile(
    const float* __restrict__ a, const float* __restrict__ b,
    const Flush& flush, int m, int n, int k, int vec) {
  const size_t g = blockIdx.z;
  repro::tile_gemm_async<BM, BN>(repro::DenseA{a + g * m * k, m, k},
                                 b + g * k * n, flush, m, n, 0, k, vec);
}

template <int BM, int BN>
__global__ void __launch_bounds__(repro::kThreads)
    batched_gemm_f32_kernel(const float* __restrict__ a,
                            const float* __restrict__ b,
                            const float* __restrict__ bias,
                            float* __restrict__ c, int m, int n, int k,
                            int relu, int vec) {
  batched_gemm_f32_tile<BM, BN>(
      a, b, repro::F32Flush{bias, c + (size_t)blockIdx.z * m * n, n, relu},
      m, n, k, vec);
}

template <int BM, int BN>
__global__ void __launch_bounds__(repro::kThreads)
    batched_gemm_f32_out_bf16_kernel(const float* __restrict__ a,
                                     const float* __restrict__ b,
                                     const float* __restrict__ bias,
                                     __nv_bfloat16* __restrict__ c, int m,
                                     int n, int k, int relu, int vec) {
  batched_gemm_f32_tile<BM, BN>(
      a, b,
      repro::CastFlush<float, __nv_bfloat16>{
          bias, c + (size_t)blockIdx.z * m * n, n, relu},
      m, n, k, vec);
}

// ---- bf16 on the mma.sync loop (tile_mma_bf16.cuh): any operand -----

template <int OUT_F32>
using Bf16Out = typename std::conditional<OUT_F32 != 0, float,
                                          __nv_bfloat16>::type;

// The bf16 tensor-core product on the mma.sync loop: bf16 A and B, f32
// sums, the flush into a bf16 C (gemm_bf16_mma_kernel) or an f32 one
// (out_dtype=f32).
template <int BM, int BN, class Out>
__device__ __forceinline__ void gemm_bf16_mma_tile(
    const uint16_t* __restrict__ a, const uint16_t* __restrict__ b,
    const __nv_bfloat16* __restrict__ bias, Out* __restrict__ c, int m, int n,
    int k, int relu, int vec) {
  repro::tile_mma_bf16_flush<BM, BN>(
      repro::DenseBf16{a, m, k}, b,
      repro::CastFlush<__nv_bfloat16, Out>{bias, c, n, relu}, m, n, k, vec);
}

template <int BM, int BN>
__global__ void __launch_bounds__(repro::kThreads)
    gemm_bf16_mma_kernel(const uint16_t* __restrict__ a,
                         const uint16_t* __restrict__ b,
                         const __nv_bfloat16* __restrict__ bias,
                         __nv_bfloat16* __restrict__ c, int m, int n, int k,
                         int relu, int vec) {
  gemm_bf16_mma_tile<BM, BN>(a, b, bias, c, m, n, k, relu, vec);
}

template <int BM, int BN>
__global__ void __launch_bounds__(repro::kThreads)
    gemm_bf16_mma_out_f32_kernel(const uint16_t* __restrict__ a,
                                 const uint16_t* __restrict__ b,
                                 const __nv_bfloat16* __restrict__ bias,
                                 float* __restrict__ c, int m, int n, int k,
                                 int relu, int vec) {
  gemm_bf16_mma_tile<BM, BN>(a, b, bias, c, m, n, k, relu, vec);
}

// Problem g = blockIdx.z of the bf16 product on the mma.sync loop. The
// entry point takes the vector path only when it holds for every g, not
// only g = 0 (batched_bf16_vector_path).
template <int BM, int BN>
__global__ void __launch_bounds__(repro::kThreads)
    batched_gemm_bf16_mma_kernel(const uint16_t* __restrict__ a,
                                 const uint16_t* __restrict__ b,
                                 const __nv_bfloat16* __restrict__ bias,
                                 __nv_bfloat16* __restrict__ c, int m, int n,
                                 int k, int relu, int vec) {
  const size_t g = blockIdx.z;
  repro::tile_mma_bf16_flush<BM, BN>(
      repro::DenseBf16{a + g * m * k, m, k}, b + g * k * n,
      repro::CastFlush<__nv_bfloat16, __nv_bfloat16>{bias, c + g * m * n, n,
                                                     relu},
      m, n, k, vec);
}

// Whether every g of a batched bf16 product can take the 16-byte path:
// bf16_vector_path for g = 0, and per-g strides that keep the same
// alignment, k % 8 (A[g] moves by g·m·k elements, a multiple of 16 bytes)
// and n % 8 (B[g] by g·k·n, C[g] by g·m·n: multiples of 16 bytes).
inline bool batched_bf16_vector_path(const void* a, const void* b, int n,
                                     int k) {
  return repro::bf16_vector_path(a, b, n, k) && k % 8 == 0 && n % 8 == 0;
}

// The split product's second pass: out = flush(Σ_s work[s]) in C's dtype.
__global__ void __launch_bounds__(repro::kReduceThreads)
    gemm_bf16_reduce_kernel(const float* __restrict__ work,
                            const __nv_bfloat16* __restrict__ bias,
                            __nv_bfloat16* __restrict__ c, long long total,
                            int n, int splits, int relu) {
  repro::reduce_slices_into(
      work, repro::CastFlush<__nv_bfloat16, __nv_bfloat16>{bias, c, n, relu},
      total, n, splits);
}

__global__ void __launch_bounds__(repro::kReduceThreads)
    gemm_bf16_out_f32_reduce_kernel(const float* __restrict__ work,
                                    const __nv_bfloat16* __restrict__ bias,
                                    float* __restrict__ c, long long total,
                                    int n, int splits, int relu) {
  repro::reduce_slices_into(
      work, repro::CastFlush<__nv_bfloat16, float>{bias, c, n, relu}, total,
      n, splits);
}

// Enqueue the reduce of a split bf16 product (out_f32: an f32 C).
inline int reduce_bf16_slices(const float* work, const __nv_bfloat16* bias,
                              void* c, int m, int n, int splits, int relu,
                              int out_f32, cudaStream_t st) {
  const long long total = (long long)m * n;
  const unsigned blocks = repro::reduce_blocks(total, n);
  if (out_f32)
    gemm_bf16_out_f32_reduce_kernel<<<blocks, repro::kReduceThreads, 0, st>>>(
        work, bias, static_cast<float*>(c), total, n, splits, relu);
  else
    gemm_bf16_reduce_kernel<<<blocks, repro::kReduceThreads, 0, st>>>(
        work, bias, static_cast<__nv_bfloat16*>(c), total, n, splits, relu);
  return (int)cudaGetLastError();
}

// ---- bf16 on the wgmma loop (tile_wgmma_bf16.cuh): TMA-able operands ----

// The tiles of `w` into C (OUT_F32: an f32 C), or each K slice z into slab
// z of the split workspace (OUT_F32, no bias, no ReLU).
template <int BM, int BN, int OUT_F32>
__global__ void __launch_bounds__(repro::WgTile<BM, BN>::kThreads, 1)
    gemm_bf16_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb,
                     const __nv_bfloat16* __restrict__ bias,
                     void* __restrict__ c, repro::WgWork w, int relu) {
  using Out = Bf16Out<OUT_F32>;
  repro::tile_wgmma_bf16<BM, BN, Out>(ta, tb, bias, static_cast<Out*>(c), w,
                                      relu);
}

// Matrix g of a batched product: the maps' third coordinate.
template <int BM, int BN>
__global__ void __launch_bounds__(repro::WgTile<BM, BN>::kThreads, 1)
    batched_gemm_bf16_kernel(const __grid_constant__ CUtensorMap ta,
                             const __grid_constant__ CUtensorMap tb,
                             const __nv_bfloat16* __restrict__ bias,
                             __nv_bfloat16* __restrict__ c, repro::WgWork w,
                             int relu) {
  repro::tile_wgmma_bf16<BM, BN, __nv_bfloat16>(ta, tb, bias, c, w, relu);
}

// The most blocks of the persistent `Kernel` (a wgmma tile with C of Out)
// the current device holds at once, read on the first launch on each
// device. The dynamic shared memory opt-in is a setting of each device's
// context, so it is made there, once a device, before the occupancy read.
// Returns that count, or a negative CUDA error code.
template <int BM, int BN, class Out, auto Kernel>
int resident_blocks() {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> cached[kMaxDevices];  // 0: not read yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev < 0 || dev >= kMaxDevices) return -(int)cudaErrorInvalidDevice;
  int blocks = cached[dev].load(std::memory_order_relaxed);
  if (blocks > 0) return blocks;
  using T = repro::WgTile<BM, BN>;
  constexpr int smem = repro::wg_smem_bytes<BM, BN, Out>();
  int per_sm = 0, sms = 0;
  if ((err = cudaFuncSetAttribute(
           Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, Kernel, T::kThreads, smem)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return -(int)err;
  if (per_sm < 1 || sms < 1) return -(int)cudaErrorInvalidConfiguration;
  cached[dev].store(per_sm * sms, std::memory_order_relaxed);
  return per_sm * sms;
}

// Launch the persistent `Kernel` on as many blocks as the current device
// holds at once, at most one a tile. Returns cudaGetLastError().
template <int BM, int BN, class Out, auto Kernel, class C>
int launch_wgmma(cudaStream_t st, const CUtensorMap& ta,
                 const CUtensorMap& tb, const __nv_bfloat16* bias, C* c,
                 const repro::WgWork& w, int relu) {
  using T = repro::WgTile<BM, BN>;
  constexpr int smem = repro::wg_smem_bytes<BM, BN, Out>();
  const int resident = resident_blocks<BM, BN, Out, Kernel>();
  if (resident < 0) return -resident;
  Kernel<<<std::min(w.tiles, resident), T::kThreads, smem, st>>>(
      ta, tb, bias, c, w, relu);
  return (int)cudaGetLastError();
}

template <int BM, int BN>
int launch_gemm_wgmma(int out_f32, cudaStream_t st, const CUtensorMap& ta,
                      const CUtensorMap& tb, const __nv_bfloat16* bias,
                      void* c, const repro::WgWork& w, int relu) {
  if (out_f32)
    return launch_wgmma<BM, BN, float, gemm_bf16_kernel<BM, BN, 1>>(
        st, ta, tb, bias, c, w, relu);
  return launch_wgmma<BM, BN, __nv_bfloat16, gemm_bf16_kernel<BM, BN, 0>>(
      st, ta, tb, bias, c, w, relu);
}

// The work of G products (m, k) · (k, n) on BM x BN tiles, K in `splits`
// slices (a dense product) or whole (batched).
inline repro::WgWork wgmma_work(int m, int n, int k, int tile_m, int tile_n,
                                int groups, int splits, int batched) {
  repro::WgWork w;
  w.m = m;
  w.n = n;
  w.k = k;
  w.tiles_m = (m + tile_m - 1) / tile_m;
  w.tiles_n = (n + tile_n - 1) / tile_n;
  w.tiles = w.tiles_m * w.tiles_n * (batched ? groups : splits);
  w.slice_chunks =
      repro::slice_depth(k, batched ? 1 : splits, repro::kWgChunk) /
      repro::kWgChunk;
  w.batched = batched;
  return w;
}

// The A and B maps of G row-major bf16 products A (G, m, k) · B (G, k, n)
// for a BM-row tile. Returns 0 or a CUDA error code.
inline int encode_operands(CUtensorMap* ta, CUtensorMap* tb, const void* a,
                           const void* b, int groups, int m, int n, int k,
                           int tile_m) {
  if (!repro::wgmma_path(a, b, n, k)) return (int)cudaErrorInvalidValue;
  const int err = repro::encode_bf16_map(ta, a, k, m, groups, tile_m);
  return err != 0 ? err : repro::encode_bf16_map(tb, b, n, k, groups, 64);
}

}  // namespace

// C (m, n) = epilogue(A (m, k) · B (k, n) [+ bias (n)]); A, B and bias
// f32, C f32 or, with out_bf16, bf16 (rounded once, in the flush); all
// contiguous, on the current device, C 16-byte aligned. bias may be NULL.
// (tile_m, tile_n) must be an instantiated tile: 64 or 128 each. K is cut
// into `splits` slices (slice_depth); with splits > 1, work is the f32
// workspace (splits, m, n) and a second kernel on the same stream sums the
// slices in order into C. vec: n % 4 == 0 and B 16-byte aligned. Returns
// cudaGetLastError().
extern "C" int gemm_f32(const void* a, const void* b, const void* bias,
                        void* c, void* work, int m, int n, int k, int tile_m,
                        int tile_n, int relu, int splits, int vec,
                        int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  const float* fbias = static_cast<const float*>(bias);
  float* fwork = static_cast<float*>(work);
  if (out_bf16)
    REPRO_DISPATCH_TILE(gemm_f32_out_bf16_kernel, tile_m, tile_n, m, n,
                        splits, st, fa, fb, fbias,
                        static_cast<__nv_bfloat16*>(c), fwork, m, n, k, relu,
                        vec);
  else
    REPRO_DISPATCH_TILE(gemm_f32_kernel, tile_m, tile_n, m, n, splits, st, fa,
                        fb, fbias, static_cast<float*>(c), fwork, m, n, k,
                        relu, vec);
  const int err = (int)cudaGetLastError();
  if (err != 0 || splits == 1) return err;
  const long long total = (long long)m * n;
  const unsigned blocks = repro::reduce_blocks(total, n);
  if (out_bf16)
    gemm_f32_out_bf16_reduce_kernel<<<blocks, repro::kReduceThreads, 0, st>>>(
        fwork, fbias, static_cast<__nv_bfloat16*>(c), total, n, splits, relu);
  else
    gemm_f32_reduce_kernel<<<blocks, repro::kReduceThreads, 0, st>>>(
        fwork, fbias, static_cast<float*>(c), total, n, splits, relu);
  return (int)cudaGetLastError();
}

// C (m, n) = epilogue(A (m, k) · B (k, n) [+ bias (n)]) with A, B and bias
// bf16, the sum in f32 on the tensor cores (the wgmma loop), bias and ReLU
// in f32, and C bf16 or, with out_f32, f32 (one round-to-nearest-even
// store); all contiguous, on the current device; A and B satisfy
// wgmma_path (else cudaErrorInvalidValue). bias may be NULL. (tile_m,
// tile_n) must be an instantiated tile: 64 or 128 each. K is cut into
// `splits` slices of whole 64-deep chunks (slice_depth); with splits > 1,
// work is the f32 workspace (splits, m, n) and a second kernel on the same
// stream sums the slices in order into C. Returns cudaGetLastError().
extern "C" int gemm_bf16(const void* a, const void* b, const void* bias,
                         void* c, void* work, int m, int n, int k, int tile_m,
                         int tile_n, int relu, int splits, int out_f32,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap ta, tb;
  int err = encode_operands(&ta, &tb, a, b, 1, m, n, k, tile_m);
  if (err != 0) return err;
  const __nv_bfloat16* hbias = static_cast<const __nv_bfloat16*>(bias);
  const repro::WgWork w = wgmma_work(m, n, k, tile_m, tile_n, 1, splits, 0);
  // A split product's slices store raw f32 partials: no bias, no ReLU.
  const __nv_bfloat16* kbias = splits == 1 ? hbias : nullptr;
  void* out = splits == 1 ? c : work;
  const int kout = splits == 1 ? out_f32 : 1, krelu = splits == 1 ? relu : 0;
  if (tile_m == 128 && tile_n == 128)
    err = launch_gemm_wgmma<128, 128>(kout, st, ta, tb, kbias, out, w, krelu);
  else if (tile_m == 128 && tile_n == 64)
    err = launch_gemm_wgmma<128, 64>(kout, st, ta, tb, kbias, out, w, krelu);
  else if (tile_m == 64 && tile_n == 128)
    err = launch_gemm_wgmma<64, 128>(kout, st, ta, tb, kbias, out, w, krelu);
  else if (tile_m == 64 && tile_n == 64)
    err = launch_gemm_wgmma<64, 64>(kout, st, ta, tb, kbias, out, w, krelu);
  else
    return (int)cudaErrorInvalidValue;
  if (err != 0 || splits == 1) return err;
  return reduce_bf16_slices(static_cast<const float*>(work), hbias, c, m, n,
                            splits, relu, out_f32, st);
}

// gemm_bf16 on the mma.sync loop, for any contiguous bf16 operands (the
// path is bf16_vector_path's); K not split.
extern "C" int gemm_bf16_mma(const void* a, const void* b, const void* bias,
                             void* c, int m, int n, int k, int tile_m,
                             int tile_n, int relu, int out_f32,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint16_t* ha = static_cast<const uint16_t*>(a);
  const uint16_t* hb = static_cast<const uint16_t*>(b);
  const __nv_bfloat16* hbias = static_cast<const __nv_bfloat16*>(bias);
  const int vec = (int)repro::bf16_vector_path(a, b, n, k);
  if (out_f32)
    REPRO_DISPATCH_TILE(gemm_bf16_mma_out_f32_kernel, tile_m, tile_n, m, n, 1,
                        st, ha, hb, hbias, static_cast<float*>(c), m, n, k,
                        relu, vec);
  else
    REPRO_DISPATCH_TILE(gemm_bf16_mma_kernel, tile_m, tile_n, m, n, 1, st, ha,
                        hb, hbias, static_cast<__nv_bfloat16*>(c), m, n, k,
                        relu, vec);
  return (int)cudaGetLastError();
}

// C (m, n) = flush(A (m, k) · B (k, n)) with A and B int8 and the sum
// exact in int32; the flush is v = (float)sum · scale[n] [+ bias[n]]
// [ReLU], stored as f32, or, when requant is nonzero, as int8:
// clamp(round-half-even(v / out_scale), ±127). scale (n) f32; bias may be
// NULL; all contiguous, on the current device; the caller keeps
// k · 127² < 2^31. (tile_m, tile_n) must be an instantiated tile: 64 or
// 128 each. Returns cudaGetLastError().
extern "C" int gemm_i8(const void* a, const void* b, const void* scale,
                       const void* bias, void* c, int m, int n, int k,
                       int tile_m, int tile_n, int relu, int requant,
                       float out_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const repro::QuantFlush flush{
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      requant ? nullptr : static_cast<float*>(c),
      requant ? static_cast<int8_t*>(c) : nullptr, out_scale, n, relu};
  REPRO_DISPATCH_TILE(gemm_i8_kernel, tile_m, tile_n, m, n, 1, s,
                      static_cast<const int8_t*>(a),
                      static_cast<const int8_t*>(b), flush, m, n, k,
                      (int)repro::i8_vector_path(a, b, n, k));
  return (int)cudaGetLastError();
}

// C[g] (m, n) = epilogue(A[g] (m, k) · B[g] (k, n) [+ bias (n)]) for
// g < groups; A (groups, m, k), B (groups, k, n) and bias f32, C (groups,
// m, n) f32 or, with out_bf16, bf16; all contiguous, on the current device,
// C 16-byte aligned. bias may be NULL. (tile_m, tile_n) must be an
// instantiated tile: 64 or 128 each. vec: n % 4 == 0 and B 16-byte
// aligned. Returns cudaGetLastError().
extern "C" int batched_gemm_f32(const void* a, const void* b,
                                const void* bias, void* c, int groups, int m,
                                int n, int k, int tile_m, int tile_n,
                                int relu, int vec, int out_bf16,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  const float* fbias = static_cast<const float*>(bias);
  if (out_bf16)
    REPRO_DISPATCH_TILE(batched_gemm_f32_out_bf16_kernel, tile_m, tile_n, m,
                        n, groups, s, fa, fb, fbias,
                        static_cast<__nv_bfloat16*>(c), m, n, k, relu, vec);
  else
    REPRO_DISPATCH_TILE(batched_gemm_f32_kernel, tile_m, tile_n, m, n, groups,
                        s, fa, fb, fbias, static_cast<float*>(c), m, n, k,
                        relu, vec);
  return (int)cudaGetLastError();
}

// C[g] (m, n) = epilogue(A[g] (m, k) · B[g] (k, n) [+ bias (n)]) for
// g < groups with A, B, bias and C bf16, the sum in f32 on the tensor cores
// (the wgmma loop, g the tensor maps' third coordinate), bias and ReLU in
// f32, one round-to-nearest-even store; all contiguous, on the current
// device; A and B satisfy wgmma_path (else cudaErrorInvalidValue), which
// holds for every g since k % 8 == 0 and n % 8 == 0. bias may be NULL.
// (tile_m, tile_n) must be an instantiated tile: 64 or 128 each. Returns
// cudaGetLastError().
extern "C" int batched_gemm_bf16(const void* a, const void* b,
                                 const void* bias, void* c, int groups, int m,
                                 int n, int k, int tile_m, int tile_n,
                                 int relu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap ta, tb;
  const int err = encode_operands(&ta, &tb, a, b, groups, m, n, k, tile_m);
  if (err != 0) return err;
  const repro::WgWork w = wgmma_work(m, n, k, tile_m, tile_n, groups, 1, 1);
  const __nv_bfloat16* hbias = static_cast<const __nv_bfloat16*>(bias);
  __nv_bfloat16* hc = static_cast<__nv_bfloat16*>(c);
  using Bf = __nv_bfloat16;
  if (tile_m == 128 && tile_n == 128)
    return launch_wgmma<128, 128, Bf, batched_gemm_bf16_kernel<128, 128>>(
        st, ta, tb, hbias, hc, w, relu);
  if (tile_m == 128 && tile_n == 64)
    return launch_wgmma<128, 64, Bf, batched_gemm_bf16_kernel<128, 64>>(
        st, ta, tb, hbias, hc, w, relu);
  if (tile_m == 64 && tile_n == 128)
    return launch_wgmma<64, 128, Bf, batched_gemm_bf16_kernel<64, 128>>(
        st, ta, tb, hbias, hc, w, relu);
  if (tile_m == 64 && tile_n == 64)
    return launch_wgmma<64, 64, Bf, batched_gemm_bf16_kernel<64, 64>>(
        st, ta, tb, hbias, hc, w, relu);
  return (int)cudaErrorInvalidValue;
}

// batched_gemm_bf16 on the mma.sync loop, for any contiguous bf16 operands
// (the path is batched_bf16_vector_path's).
extern "C" int batched_gemm_bf16_mma(const void* a, const void* b,
                                     const void* bias, void* c, int groups,
                                     int m, int n, int k, int tile_m,
                                     int tile_n, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_TILE(batched_gemm_bf16_mma_kernel, tile_m, tile_n, m, n,
                      groups, s, static_cast<const uint16_t*>(a),
                      static_cast<const uint16_t*>(b),
                      static_cast<const __nv_bfloat16*>(bias),
                      static_cast<__nv_bfloat16*>(c), m, n, k, relu,
                      (int)batched_bf16_vector_path(a, b, n, k));
  return (int)cudaGetLastError();
}
