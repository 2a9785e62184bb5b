// Output tiles of C = flush(A · B) for row-major bf16 A (m, k) and B (k, n),
// summed in f32 on the bf16 tensor cores by Hopper's warpgroup MMA: the
// mainloop of gemm.cu's gemm_bf16 and batched_gemm_bf16 (dense operands
// whose rows TMA can address), beside tile_mma_bf16.cuh's mma.sync loop,
// which the entry points keep for any other operand.
//
// Persistent blocks. A launch has as many blocks as the card holds at once
// (at most one a tile); block b takes tiles b, b + gridDim.x, … of the
// launch's work (WgWork: a batched product's matrices or a split product's
// K slices times the row and column blocks), so one tile's flush overlaps
// the loads of the next.
//
// Loads. K is walked in kWgChunk-deep chunks (64 bf16: one 128-byte row of
// a 128-byte swizzle atom) through a ring of kWgStages stages in dynamic
// shared memory, each filled by the Tensor Memory Accelerator: one A box
// (BM rows x 64 k, K-major) and BN / 64 B boxes (64 k x 64 n, MN-major:
// B's rows are n-contiguous), all 128-byte swizzled, from 3-D tensor maps
// (inner dim, rows, matrices) that the host encodes at each launch
// (encode_bf16_map) and passes by value as __grid_constant__ parameters,
// so a CUDA graph captures them with the launch. Rows, columns and chunks
// past the operands' ends come in as zeros; a batched product's matrix g
// is the maps' third coordinate, so a ragged tile never reads matrix
// g + 1. One producer thread (lane 0 of the last warp) walks the block's
// tiles and chunks: it waits for a stage's `empty` barrier, arms its
// `full` barrier with the stage's bytes (mbarrier expect-tx) and issues
// its copies; the consumers wait on `full` and, once the MMAs that read a
// stage are done, arrive on its `empty` barrier (every consumer thread:
// the count is 128 x kConsumers). The stages and phases run on across
// tile boundaries.
//
// Math. BM / 64 consumer warpgroups (warps 0 .. 4 BM / 64 - 1, so each
// warpgroup starts on a warp index divisible by 4), each owning 64 rows x BN
// columns of a tile: four wgmma.mma_async m64nBNk16 per chunk (f32
// accumulators in registers, BN / 2 a thread), A read K-major and B
// MN-major (tnspB = 1) from their swizzled stages through 64-bit matrix
// descriptors, so B is never transposed by threads. A chunk's four
// products are one commit group; wgmma.wait_group 1 keeps it in flight
// while the next chunk is awaited and issued, and the wait's return
// releases the previous chunk's stage; a tile's last stage is released
// after wait_group 0.
//
// Flush. Each warpgroup stages its 64 x BN outputs in a shared-memory
// region of its own past the ring: the f32 sum, bias widened (__fadd_rn)
// and ReLU (CastFlush::value), one round-to-nearest-even into Out (bf16,
// or f32 for out_dtype=f32 and for split-K partials, which take no bias
// and no ReLU). Its rows are then written back in 16-byte stores,
// consecutive threads on consecutive pieces of a row, masked at the ragged
// M and N edges (n % 8 == 0, so a 16-byte piece is wholly in or out).
//
// What TMA needs (wgmma_path): k % 8 == 0 and n % 8 == 0 (16-byte row
// strides of A and B, and of a batched product's matrices) and 16-byte
// aligned A and B; the outputs the wrappers allocate are aligned.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_gemm.cuh"

namespace repro {

constexpr int kWgChunk = 64;   // K depth of one stage, elements
constexpr int kWgStages = 4;   // stages of the ring

// Whether dense bf16 (a, b, n, k) can take the TMA / wgmma loop.
inline bool wgmma_path(const void* a, const void* b, int n, int k) {
  return k % 8 == 0 && n % 8 == 0 &&
         reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

template <int BM, int BN>
struct WgTile {
  static_assert((BM == 64 || BM == 128) && (BN == 64 || BN == 128),
                "the tiles kernel_tile picks");
  static constexpr int kConsumers = BM / 64;  // warpgroups
  static constexpr int kThreads = 128 * kConsumers + 32;
  static constexpr int kABytes = BM * 128;    // BM rows x 64 k
  static constexpr int kBBytes = BN * 128;    // BN / 64 panels x 64 k x 128 B
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kRingBytes = kWgStages * kStageBytes;
};

// ---- Host: tensor maps -------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// library need not link libcuda; null if the driver has none.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// The 3-D map of `mats` row-major bf16 matrices (rows, inner) at `base`,
// cut into 128-byte swizzled boxes of box_rows x 64 inner elements.
// Returns 0 or a CUDA error code.
inline int encode_bf16_map(CUtensorMap* map, const void* base,
                           uint64_t inner, uint64_t rows, uint64_t mats,
                           uint32_t box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {inner, rows, mats};
  const cuuint64_t strides[2] = {inner * 2, inner * rows * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kWgChunk, box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// ---- Device: barriers, TMA, wgmma --------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Spin until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One box of the 3-D map at coordinates (c0 inner, c1 row, c2 matrix)
// into shared memory, completing `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma matrix descriptor of a 128-byte swizzled operand at shared
// address `addr` (1024-byte aligned atoms; a start inside an atom's first
// row selects a k16 step): leading and stride byte offsets in bytes.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across an
// asynchronous MMA's issue or wait.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One m64nNk16 product into d (N / 2 f32 a thread), A K-major and B
// MN-major (tnspB = 1) in shared memory, both 128-byte swizzled; scale-d
// is 1: d accumulates.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_k16(float (&d)[BN / 2], uint64_t da,
                                          uint64_t db) {
  if constexpr (BN == 128)
    wgmma_m64n128k16(d, da, db);
  else
    wgmma_m64n64k16(d, da, db);
}

// The work of one launch: tiles_z x tiles_m x tiles_n output tiles, tile t
// at (z, row block, column block) = (t / (tiles_m tiles_n), t / tiles_n %
// tiles_m, t % tiles_n), so the blocks that run at once share A's rows.
// z is a batched product's matrix (the maps' third coordinate, and C's
// matrix) or a split product's K slice (chunks [z · slice_chunks, +
// slice_chunks) of K, and slab z of the f32 workspace); slice_chunks holds
// all of K otherwise.
struct WgWork {
  int m, n, k, tiles_m, tiles_n, tiles, slice_chunks, batched;
};

// The persistent mainloop: block b takes tiles b, b + gridDim.x, … of
// `work`, its producer running ahead across tile boundaries (the ring's
// stages and phases run on over every chunk the block takes), so one
// tile's flush overlaps the next tile's loads. Each tile goes to out + z m n
// (of Out): bias (bf16, widened; may be null) and ReLU, one rounding.
// Launched with WgTile<BM, BN>::kThreads threads and wg_smem_bytes<BM, BN,
// Out>() bytes of dynamic shared memory.
template <int BM, int BN, class Out>
__device__ __forceinline__ void tile_wgmma_bf16(
    const CUtensorMap& ta, const CUtensorMap& tb,
    const __nv_bfloat16* __restrict__ bias, Out* __restrict__ out,
    const WgWork& w, int relu) {
  using T = WgTile<BM, BN>;
  constexpr int kAcc = BN / 2;
  constexpr int kRow = BN * (int)sizeof(Out) + 16;  // a staged row
  extern __shared__ uint8_t wg_smem_raw[];
  __shared__ __align__(8) uint64_t full[kWgStages], empty[kWgStages];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int chunks_k = (w.k + kWgChunk - 1) / kWgChunk;
  const int per_z = w.tiles_m * w.tiles_n;

  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * T::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * T::kConsumers) {  // the producer warp
    if (tid % 32 == 0) {
      int i = 0;  // chunks this block has loaded, over all its tiles
      for (int t = blockIdx.x; t < w.tiles; t += gridDim.x) {
        const int z = t / per_z;
        const int m0 = (t / w.tiles_n % w.tiles_m) * BM;
        const int n0 = t % w.tiles_n * BN;
        const int c0 = w.batched ? 0 : z * w.slice_chunks;
        const int c1 = min(chunks_k, c0 + w.slice_chunks);
        const int mat = w.batched ? z : 0;
        for (int c = c0; c < c1; ++c, ++i) {
          const int s = i % kWgStages, round = i / kWgStages;
          if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
          uint8_t* stage = ring + s * T::kStageBytes;
          mbar_expect_tx(&full[s], T::kStageBytes);
          tma_load_3d(stage, &ta, &full[s], c * kWgChunk, m0, mat);
#pragma unroll
          for (int p = 0; p < BN / 64; ++p)
            tma_load_3d(stage + T::kABytes + p * 8192, &tb, &full[s],
                        n0 + 64 * p, c * kWgChunk, mat);
        }
      }
    }
    return;
  }

  // A consumer warpgroup: rows 64 wg .. 64 wg + 63 of each tile, staged
  // for the flush in a region of its own past the ring.
  const int wg = warp / 4, t128 = tid % 128;
  uint8_t* stg = ring + T::kRingBytes + wg * 64 * kRow;
  const CastFlush<__nv_bfloat16, Out> f{bias, out, w.n, relu};
  const int r0 = 16 * (t128 / 32) + (t128 % 32) / 4, q2 = 2 * (t128 % 4);
  int i = 0;  // chunks this block has consumed, over all its tiles
  for (int t = blockIdx.x; t < w.tiles; t += gridDim.x) {
    const int z = t / per_z;
    const int m0 = (t / w.tiles_n % w.tiles_m) * BM;
    const int n0 = t % w.tiles_n * BN;
    const int c0 = w.batched ? 0 : z * w.slice_chunks;
    const int chunks = min(chunks_k, c0 + w.slice_chunks) - c0;
    float acc[kAcc];
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[e] = 0.f;
    for (int c = 0; c < chunks; ++c, ++i) {
      const int s = i % kWgStages;
      mbar_wait(&full[s], (i / kWgStages) & 1);
      const uint32_t a0 = smem_addr(ring + s * T::kStageBytes) + wg * 8192;
      const uint32_t b0 = smem_addr(ring + s * T::kStageBytes + T::kABytes);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgChunk / 16; ++kk)
        // A: a k16 step is 32 bytes along the swizzled row, 8-row groups
        // 1024 bytes apart. B: a k16 step is 16 rows of 128 bytes, 8-row
        // groups 1024 bytes apart, 64-column panels 8192 bytes apart.
        wgmma_k16<BN>(acc, wg_desc(a0 + 32 * kk, 16, 1024),
                      wg_desc(b0 + 2048 * kk, 8192, 1024));
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(acc);
      if (c > 0) mbar_arrive(&empty[(i - 1) % kWgStages]);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (chunks > 0) mbar_arrive(&empty[(i - 1) % kWgStages]);

    // Stage the flushed values: acc[4 j + 2 h + e] is row r0 + 8 h,
    // column 8 j + q2 + e of the warpgroup's 64 x BN. The barrier first
    // waits for the warpgroup's stores of the previous tile.
    named_sync(2 + wg, 128);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + q2;
      const bool in = n0 + col < w.n;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = in ? f.value(n0 + col, acc[4 * j + 2 * h]) : 0.f;
        const float v1 =
            in ? f.value(n0 + col + 1, acc[4 * j + 2 * h + 1]) : 0.f;
        store_pair(reinterpret_cast<Out*>(stg + (r0 + 8 * h) * kRow) + col,
                   v0, v1);
      }
    }
    named_sync(2 + wg, 128);
    constexpr int kPer = 16 / (int)sizeof(Out);  // values a 16-byte piece
    Out* dst = out + (size_t)z * w.m * w.n;
#pragma unroll 4
    for (int q = t128; q < 64 * BN / kPer; q += 128) {
      const int row = q / (BN / kPer), col = q % (BN / kPer) * kPer;
      const int gm = m0 + 64 * wg + row, gn = n0 + col;
      if (gm < w.m && gn < w.n)
        *reinterpret_cast<uint4*>(dst + (size_t)gm * w.n + gn) =
            *reinterpret_cast<const uint4*>(stg + row * kRow +
                                            col * (int)sizeof(Out));
    }
  }
}

// The dynamic shared memory of a wgmma tile with C of Out: the ring, the
// consumers' staging and 1 KB to align the ring.
template <int BM, int BN, class Out>
constexpr int wg_smem_bytes() {
  return WgTile<BM, BN>::kRingBytes +
         WgTile<BM, BN>::kConsumers * 64 * (BN * (int)sizeof(Out) + 16) + 1024;
}

}  // namespace repro
