// Hopper tensor-core building blocks shared by the bf16 kernels of
// flash_attn.cu and moe_experts.cu: warpgroup MMA (`wgmma`, sm_90a) on bf16
// operands with float32 accumulation, its shared-memory descriptors, and
// cp.async staging of tiles into the layout those descriptors describe.
//
// Shared-memory tile layout: the 128-byte swizzle that wgmma reads at full
// rate (an unswizzled tile of 8 x 16-byte core matrices costs it bank
// conflicts and ran ~8x slower). A tile of R rows x W columns of bf16 (R a
// multiple of 8, W of 64) is stored as W / 64 column blocks of R rows x 128
// bytes, each based on a 1024-byte boundary; in a block, the 16-byte chunk
// j of row r sits at chunk j ^ (r % 8):
//
//   element (r, c) at (c / 64) * R * 64 + r * 64
//                     + (((c % 64) / 8) ^ (r % 8)) * 8 + c % 8
//
// The hardware applies the XOR to address bits 4-6 from bits 7-9, so every
// descriptor start below keeps bits 7-9 of the block's pattern. One
// 16-byte chunk of a row-major global array lands in one 16-byte slot, and
// 8 consecutive threads fill one 128-byte row: no bank conflict. Read by
// wgmma (swizzle mode 1), such a tile is
//
//   * K-major (columns are the reduction axis K, rows are M or N): the next
//     8 rows are 1024 bytes on (the descriptor's stride byte offset, SBO);
//     a 16-deep K step kk starts (kk / 4) * R * 128 + (kk % 4) * 32 bytes
//     on (inside one 128-byte row, so the leading byte offset is unused);
//   * MN-major (rows are K, columns are M or N; the transpose flag set):
//     the next 64 columns along M or N are R * 128 bytes on (leading byte
//     offset, LBO), the next 8 rows along K 1024 bytes on (SBO); a 16-deep
//     K step starts 2048 bytes further.
//
// Accumulator layout of m64nNk16 (float32, 128 threads): thread t of the
// warpgroup (warp w = t / 32, g = (t % 32) / 4, q = t % 4) holds
// d[4 j + 2 i + c] = C[16 w + g + 8 i][8 j + 2 q + c] for j < N / 8, i, c in
// {0, 1}. The register A operand of a 16-deep step holds, as bf16 pairs
// (lower column in the low half), A[16 w + g][2 q + {0,1}],
// A[16 w + g + 8][2 q + {0,1}], A[16 w + g][8 + 2 q + {0,1}] and
// A[16 w + g + 8][8 + 2 q + {0,1}]: the accumulator registers
// d[8 k .. 8 k + 7] of columns 16 k .. 16 k + 15 in that order, so a score
// tile feeds the next product without leaving registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

constexpr int WG_THREADS = 128;   // one warpgroup

// Descriptor of a shared-memory operand in the 128-byte swizzle (mode 1,
// base offset 0: every start keeps its block's bits 7-9).
__device__ __forceinline__ uint64_t desc(const void* smem, uint32_t lbo,
                                         uint32_t sbo) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Descriptor of the 16-deep K step `kk` of a tile of R rows, read K-major
// (columns are K) starting `mn0` rows into M or N, or MN-major (rows are
// K) starting `mn0` columns into M or N; mn0 a multiple of 8 (K-major) or
// of 64 (MN-major).
template <int R>
__device__ __forceinline__ uint64_t desc_kmajor(const __nv_bfloat16* tile,
                                                int kk, int mn0 = 0) {
  return desc(tile + (kk / 4) * R * 64 + mn0 * 64 + (kk % 4) * 16, 16,
              1024);
}
template <int R>
__device__ __forceinline__ uint64_t desc_mnmajor(const __nv_bfloat16* tile,
                                                 int kk, int mn0 = 0) {
  return desc(tile + (mn0 / 64) * R * 64 + kk * 1024, R * 128, 1024);
}

// `p` rounded up to the next 1024-byte boundary (tile bases; a kernel asks
// for 1024 bytes more dynamic shared memory than its tiles take).
__device__ __forceinline__ __nv_bfloat16* align_1k(void* p) {
  return reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ void wg_arrive() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup's MMAs are
// still in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wg_wait_all() { wg_wait<0>(); }
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous MMAs (the registers are live in the tensor cores between
// issue and wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Generic-proxy writes to shared memory (cp.async, st.shared) made visible
// to the tensor cores' async proxy; then a barrier.
__device__ __forceinline__ void fence_smem_for_wgmma() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [0, nrows) x columns [0, ncols) of a row-major bf16 array
// into an R x W tile (the layout above), zero elsewhere, by the first
// THREADS threads of the CTA. `row(r)` is the global address of row r's
// first element. Aligned full chunks go by cp.async (the caller commits
// and waits); ragged or unaligned ones are loaded element by element.
template <int R, int W, int THREADS = WG_THREADS, typename RowFn>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* tile, RowFn row,
                                           int nrows, int ncols) {
  constexpr int CPR = W / 8;                 // 16-byte chunks a row
  static_assert(W % 64 == 0 && R % 8 == 0, "128-byte swizzle atoms");
  static_assert(R * CPR % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < R * CPR / THREADS; ++i) {
    const int ch = threadIdx.x + i * THREADS;
    const int r = ch / CPR, j = ch % CPR, c = j * 8;
    __nv_bfloat16* dst = tile + (j / 8) * R * 64 + r * 64 +
                         ((j % 8) ^ (r % 8)) * 8;
    if (r < nrows && c < ncols) {
      const __nv_bfloat16* src = row(r) + c;
      if (c + 8 <= ncols && ((uintptr_t)src & 15) == 0) {
        cp_async16(dst, src);
      } else {
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = c + e < ncols ? src[e] : __float2bfloat16_rn(0.0f);
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
      }
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
}

// Two float32 values as one register of bf16 (a first, in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x by the SFU (ex2.approx, relative error ~2^-22; results below 2^-126
// flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x = hi + rest with hi = bf16(x): returns hi as float32 and leaves the
// exact float32 remainder in x.
__device__ __forceinline__ float split_bf16(float& x) {
  const float hi = __bfloat162float(__float2bfloat16_rn(x));
  x -= hi;
  return hi;
}

// wgmma.mma_async m64nNk16, float32 += bf16 x bf16. `_ss`: A and B from
// shared-memory descriptors, TA / TB the transpose (MN-major) flags. `_rs`:
// A from registers (the layout above), B a descriptor. scale_d 0 overwrites
// the accumulator, 1 adds to it.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

}  // namespace tc
