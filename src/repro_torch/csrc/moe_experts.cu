// MoE expert FFN for Hopper: y = (silu(x W_in[:, :F]) * x W_in[:, F:]) W_out
// per expert, float32 inside.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_experts.py
// (moe_expert_ffn, body _kernel), which runs one grid program per
// (expert, capacity block) of one sequence and is vmapped over the batch.
// Here one launch covers the whole batch: x is [B, E, C, D] (or [E, C, D],
// B = 1), w_in [E, D, 2F], w_out [E, F, D], y has x's shape and dtype; C
// is taken unpadded. Products of bf16 inputs are exact in float32 and
// every sum is float32, as in the TPU body; y is rounded once to x's type.
//
// What bounds it on this card: at a 4 x 512-token prefill (C = 129) the
// call does ~97 GFLOP against ~316 MB, operation-bound at the bf16
// tensor-core rate; a decode step (C = 8) moves the 189 MB of expert
// weights for ~6 GFLOP, byte-bound.
//
// bfloat16 inputs run on the tensor cores, in two launches per call. The
// TPU body's one-launch fusion does not fit an SM at granite's width: a
// [64, D = 1536] float32 output tile is 384 KB, more than an SM's
// registers or shared memory, and splitting D across CTAs would recompute
// the first product. So:
//
//   (a) moe_up_wgmma_kernel: one warpgroup per (row tile, 64 hidden
//       columns, expert); the rows are gathered across the B sequences of
//       the expert as below. A 3-stage cp.async ring stages 64-deep slices
//       of x and of the gate and up columns of W_in (bf16, the 128-byte
//       swizzled layout of wgmma.cuh); a gate and an up wgmma per 16-deep
//       step put gate[j] and up[j] of one (row, column) in the same thread,
//       so the epilogue silu(g) * u is thread-local, in float32 (expf, as
//       the FMA body). h is float32 in the TPU body; it is written as three
//       bf16 planes, hi = bf16(h), mid = bf16(h - hi), lo = bf16(h - hi -
//       mid), which carry float32's 24-bit mantissa, to scratch the wrapper
//       allocates ([3, E, B*C, F]);
//   (b) moe_down_wgmma_kernel: one warpgroup per (row tile, output column
//       tile, expert); per 16-deep step of F, three wgmmas (hi, mid, lo)
//       share the W_out tile, so y is as exact as a float32 product; y is
//       rounded once to bf16.
//
// Prefill shapes put 64 token rows in wgmma's M slot (tiles 64 x 64 in
// (a), 64 x 128 in (b); CTAs of two warpgroups sharing 128 x 64 and
// 64 x 256 tiles measured no faster on an H100). Each slice's MMAs run
// while the next slice is staged (the ring waits for the previous slice's
// MMAs, not its own). At B*C <= 32 (a decode step) the shape is
// byte-bound and the operands swap: the weights fill the 64-row M slot
// (MN-major A) and the <= 32 token rows are N (m64n32), so no MMA row is
// padding and the weights of each expert stream once, over E x F / 64
// CTAs in (a) and E x D / 64 in (b). Ragged D, F and B*C are zero-padded
// in shared memory; chunks that are not 16-byte aligned (D or F not a
// multiple of 8) are staged element by element. No float atomics: every
// output is owned by one thread.
//
// float32 inputs keep the FMA body (moe_expert_ffn_kernel), one launch,
// the hidden activations never in device memory:
//
//   * one CTA per (block of R rows, expert). The R rows are gathered across
//     the B sequences of that expert (row r of the B*C is sequence r / C,
//     slot r % C), so W_e streams once per row block rather than once per
//     sequence, and CTAs of one expert run next to each other (grid x is
//     the row block) and share W_e through L2;
//   * the R rows of x are staged in shared memory as float32 [R, D];
//   * first product: each thread owns hidden column pairs (j, j+1) of the
//     gate half and the same pair of the up half, so SwiGLU is
//     thread-local; W_in rows are read coalesced (a warp reads 64
//     consecutive columns), x values are float4 broadcasts from shared
//     memory; the [R, F] SwiGLU tile is written to shared memory;
//   * second product: each thread owns output column pairs; W_out rows are
//     read coalesced, the hidden tile as float4 broadcasts;
//   * sums run over the reduction in chunks of KC terms whose partial sums
//     are added to a running total, which keeps float32 rounding within a
//     few ulp of a blocked matmul at D = 1536. No float atomics: each
//     output element is owned by one thread.
//
// R is 16, 8 or 4 (template), the largest whose R * (D + F) float32
// shared tile fits the card, and 16 only when it still leaves two CTAs per
// SM. D and F must be multiples of 4 (float4 rows, pair loads).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int KC = 32;

__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ float silu(float g) {
  return g * (1.0f / (1.0f + expf(-g)));
}

// Offset of row r (0 <= r < B*C) of expert e in the [B, E, C, D] layout.
__device__ __forceinline__ long long row_offset(int r, int e, int E, int C,
                                                int D) {
  const int b = r / C, c = r - b * C;
  return (((long long)b * E + e) * C + c) * D;
}

template <typename T, int R>
__global__ void __launch_bounds__(THREADS)
moe_expert_ffn_kernel(const T* __restrict__ x, const T* __restrict__ w_in,
                      const T* __restrict__ w_out, T* __restrict__ y, int BC,
                      int E, int C, int D, int F) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;              // [R, D]
  float* hs = smem + R * D;      // [R, F]
  const int e = blockIdx.y;
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, BC - row0);
  const int tid = threadIdx.x;

  for (int r = 0; r < R; ++r) {
    const bool live = r < nrows;
    const T* src = live ? x + row_offset(row0 + r, e, E, C, D) : x;
    for (int d = tid; d < D; d += THREADS)
      xs[r * D + d] = live ? to_f32(src[d]) : 0.0f;
  }
  __syncthreads();

  // ---- h = x W_in, SwiGLU, into hs --------------------------------------
  const T* wi = w_in + (long long)e * D * 2 * F;
  for (int j = 2 * tid; j < F; j += 2 * THREADS) {
    float g[R][2], u[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) g[r][0] = g[r][1] = u[r][0] = u[r][1] = 0.f;
    for (int d0 = 0; d0 < D; d0 += KC) {
      const int d1 = min(D, d0 + KC);
      float pg[R][2], pu[R][2];
#pragma unroll
      for (int r = 0; r < R; ++r)
        pg[r][0] = pg[r][1] = pu[r][0] = pu[r][1] = 0.f;
      for (int d = d0; d < d1; d += 4) {
        float2 wg[4], wu[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const T* row = wi + (long long)(d + k) * 2 * F;
          wg[k] = load2(row + j);
          wu[k] = load2(row + F + j);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 xv = *reinterpret_cast<const float4*>(xs + r * D + d);
          const float xk[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            pg[r][0] = fmaf(xk[k], wg[k].x, pg[r][0]);
            pg[r][1] = fmaf(xk[k], wg[k].y, pg[r][1]);
            pu[r][0] = fmaf(xk[k], wu[k].x, pu[r][0]);
            pu[r][1] = fmaf(xk[k], wu[k].y, pu[r][1]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        g[r][0] += pg[r][0]; g[r][1] += pg[r][1];
        u[r][0] += pu[r][0]; u[r][1] += pu[r][1];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      hs[r * F + j] = silu(g[r][0]) * u[r][0];
      hs[r * F + j + 1] = silu(g[r][1]) * u[r][1];
    }
  }
  __syncthreads();

  // ---- y = hs W_out ------------------------------------------------------
  const T* wo = w_out + (long long)e * F * D;
  for (int c = 2 * tid; c < D; c += 2 * THREADS) {
    float acc[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = 0.f;
    for (int f0 = 0; f0 < F; f0 += KC) {
      const int f1 = min(F, f0 + KC);
      float p[R][2];
#pragma unroll
      for (int r = 0; r < R; ++r) p[r][0] = p[r][1] = 0.f;
      for (int f = f0; f < f1; f += 4) {
        float2 w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) w[k] = load2(wo + (long long)(f + k) * D + c);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 hv = *reinterpret_cast<const float4*>(hs + r * F + f);
          const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            p[r][0] = fmaf(hk[k], w[k].x, p[r][0]);
            p[r][1] = fmaf(hk[k], w[k].y, p[r][1]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r][0] += p[r][0]; acc[r][1] += p[r][1];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < nrows)
        store2(y + row_offset(row0 + r, e, E, C, D) + c, acc[r][0], acc[r][1]);
  }
}

size_t smem_bytes(int rows, int D, int F) {
  return (size_t)rows * (D + F) * sizeof(float);
}

template <typename T, int R>
int launch_rows(const void* x, const void* w_in, const void* w_out, void* y,
                int BC, int E, int C, int D, int F, cudaStream_t stream) {
  const size_t smem = smem_bytes(R, D, F);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_expert_ffn_kernel<T, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((BC + R - 1) / R, E);
  moe_expert_ffn_kernel<T, R><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_in),
      static_cast<const T*>(w_out), static_cast<T*>(y), BC, E, C, D, F);
  return (int)cudaGetLastError();
}

// ---- bfloat16: the two tensor-core launches ------------------------------

using bf16 = __nv_bfloat16;
constexpr int BK = 64;         // reduction depth of one pipeline stage
constexpr int SWAP_ROWS = 32;  // B*C up to this takes the swapped tiles

// Tiles of the two launches, one warpgroup a CTA: token rows, columns
// (hidden in (a), output in (b)) and pipeline stages. The swapped tiles
// are 64 weight columns (M) x 32 token rows (N).
template <bool SWAP> struct UpTile {
  static constexpr int ROWS = SWAP ? 32 : 64, COLS = 64;
  static constexpr int STAGES = 3;
  static constexpr int STAGE = ROWS * BK + 2 * BK * COLS;   // elements
};
template <bool SWAP> struct DownTile {
  static constexpr int ROWS = SWAP ? 32 : 64, COLS = SWAP ? 64 : 128;
  static constexpr int STAGES = SWAP ? 3 : 2;
  static constexpr int STAGE = 3 * ROWS * BK + BK * COLS;
};
// The ring, and room to align its tiles to 1024 bytes.
template <typename T> constexpr size_t tile_smem() {
  return (size_t)T::STAGES * T::STAGE * sizeof(bf16) + 1024;
}

// The k-stage ring shared by both launches: stage(kt) stages slice kt into
// its slot (cp.async); mma(slot) issues and commits the wgmmas of a staged
// slice. Each slice is waited for, fenced for the async proxy and made
// visible by a barrier; its MMAs then run while the previous slice's are
// waited for and, after a barrier, the slot that slice leaves is refilled
// STAGES - 1 slices ahead. The caller waits for the last MMAs.
template <int STAGES, typename StageFn, typename MmaFn>
__device__ __forceinline__ void k_ring(int nk, StageFn stage, MmaFn mma) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) stage(s);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    tc::cp_async_wait<STAGES - 2>();
    tc::fence_smem_for_wgmma();
    __syncthreads();
    mma(kt % STAGES);
    tc::wg_wait<1>();                 // slice kt - 1's MMAs are done
    __syncthreads();                  // ... in every warpgroup
    if (kt + STAGES - 1 < nk) stage(kt + STAGES - 1);
    tc::cp_async_commit();
  }
  tc::cp_async_wait<0>();
}

// Offsets in the [B, E, C, D] layout of the CTA's `rows` gathered rows
// (row0 + r of expert e), one division each, computed once per CTA.
__device__ __forceinline__ void gather_offsets(long long* off, int rows,
                                               int row0, int nrows, int e,
                                               int E, int C, int D) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    off[r] = r < nrows ? row_offset(row0 + r, e, E, C, D) : 0;
  __syncthreads();
}

// Accumulator element x of thread tid: (M index, N index).
__device__ __forceinline__ int acc_m(int x, int tid) {
  return 16 * (tid >> 5) + ((tid & 31) >> 2) + 8 * ((x >> 1) & 1);
}
__device__ __forceinline__ int acc_n(int x, int tid) {
  return 8 * (x >> 2) + 2 * (tid & 3) + (x & 1);
}

template <bool SWAP>
__global__ void __launch_bounds__(tc::WG_THREADS)
moe_up_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w_in,
                    bf16* __restrict__ h3, int BC, int E, int C, int D,
                    int F) {
  using T = UpTile<SWAP>;
  constexpr int XS = T::ROWS * BK, WS = BK * T::COLS;
  constexpr int NA = SWAP ? 16 : 32;     // m64n32 or m64n64 accumulator
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = tc::align_1k(smem_raw);
  __shared__ long long x_off[T::ROWS];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * T::ROWS, f0 = blockIdx.y * T::COLS;
  const int e = blockIdx.z;
  const int nrows = min(T::ROWS, BC - row0), ncols = min(T::COLS, F - f0);
  const bf16* wi = w_in + (long long)e * D * 2 * F;
  gather_offsets(x_off, T::ROWS, row0, nrows, e, E, C, D);

  float g[NA], u[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) g[i] = u[i] = 0.0f;
  auto stage = [&](int kt) {
    bf16* s = ring + (kt % T::STAGES) * T::STAGE;
    const int k0 = kt * BK, depth = min(BK, D - k0);
    tc::stage_tile<T::ROWS, BK>(
        s, [&](int r) { return x + x_off[r] + k0; }, nrows, depth);
    tc::stage_tile<BK, T::COLS>(
        s + XS, [&](int r) { return wi + (long long)(k0 + r) * 2 * F + f0; },
        depth, ncols);
    tc::stage_tile<BK, T::COLS>(
        s + XS + WS,
        [&](int r) { return wi + (long long)(k0 + r) * 2 * F + F + f0; },
        depth, ncols);
  };
  auto mma = [&](int slot) {
    const bf16* s = ring + slot * T::STAGE;
    tc::wg_arrive();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dx = tc::desc_kmajor<T::ROWS>(s, kk);
      const uint64_t dg = tc::desc_mnmajor<BK>(s + XS, kk);
      const uint64_t du = tc::desc_mnmajor<BK>(s + XS + WS, kk);
      if constexpr (SWAP) {     // M: hidden columns, N: token rows
        tc::wgmma_ss_n32<1, 0>(g, dg, dx, 1);
        tc::wgmma_ss_n32<1, 0>(u, du, dx, 1);
      } else {                  // M: token rows, N: hidden columns
        tc::wgmma_ss_n64<0, 1>(g, dx, dg, 1);
        tc::wgmma_ss_n64<0, 1>(u, dx, du, 1);
      }
    }
    tc::wg_commit();
  };
  k_ring<T::STAGES>((D + BK - 1) / BK, stage, mma);
  tc::wg_wait_all();
  tc::fence_regs(g);
  tc::fence_regs(u);

  const long long plane = (long long)E * BC * F;
  bf16* hb = h3 + ((long long)e * BC + row0) * F + f0;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int r = SWAP ? acc_n(i, tid) : acc_m(i, tid);
    const int c = SWAP ? acc_m(i, tid) : acc_n(i, tid);
    if (r < nrows && c < ncols) {
      float h = silu(g[i]) * u[i];
      const float hi = tc::split_bf16(h);
      const float mid = tc::split_bf16(h);
      bf16* dst = hb + (long long)r * F + c;
      dst[0] = __float2bfloat16_rn(hi);
      dst[plane] = __float2bfloat16_rn(mid);
      dst[2 * plane] = __float2bfloat16_rn(h);
    }
  }
}

template <bool SWAP>
__global__ void __launch_bounds__(tc::WG_THREADS)
moe_down_wgmma_kernel(const bf16* __restrict__ h3,
                      const bf16* __restrict__ w_out, bf16* __restrict__ y,
                      int BC, int E, int C, int D, int F) {
  using T = DownTile<SWAP>;
  constexpr int HS = T::ROWS * BK;
  constexpr int NA = SWAP ? 16 : 64;     // m64n32 or m64n128 accumulator
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = tc::align_1k(smem_raw);
  __shared__ long long y_off[T::ROWS];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * T::ROWS, d0 = blockIdx.y * T::COLS;
  const int e = blockIdx.z;
  const int nrows = min(T::ROWS, BC - row0), ncols = min(T::COLS, D - d0);
  gather_offsets(y_off, T::ROWS, row0, nrows, e, E, C, D);
  const long long plane = (long long)E * BC * F;
  const bf16* hb = h3 + ((long long)e * BC + row0) * F;
  const bf16* wo = w_out + (long long)e * F * D + d0;

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.0f;
  auto stage = [&](int kt) {
    bf16* s = ring + (kt % T::STAGES) * T::STAGE;
    const int k0 = kt * BK, depth = min(BK, F - k0);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      tc::stage_tile<T::ROWS, BK>(
          s + p * HS,
          [&](int r) { return hb + p * plane + (long long)r * F + k0; },
          nrows, depth);
    tc::stage_tile<BK, T::COLS>(
        s + 3 * HS, [&](int r) { return wo + (long long)(k0 + r) * D; },
        depth, ncols);
  };
  auto mma = [&](int slot) {
    const bf16* s = ring + slot * T::STAGE;
    tc::wg_arrive();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dw = tc::desc_mnmajor<BK>(s + 3 * HS, kk);
#pragma unroll
      for (int p = 0; p < 3; ++p) {       // h's hi, mid and lo planes
        const uint64_t dh = tc::desc_kmajor<T::ROWS>(s + p * HS, kk);
        if constexpr (SWAP)               // M: output columns, N: rows
          tc::wgmma_ss_n32<1, 0>(acc, dw, dh, 1);
        else                              // M: rows, N: output columns
          tc::wgmma_ss_n128<0, 1>(acc, dh, dw, 1);
      }
    }
    tc::wg_commit();
  };
  k_ring<T::STAGES>((F + BK - 1) / BK, stage, mma);
  tc::wg_wait_all();
  tc::fence_regs(acc);

#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int r = SWAP ? acc_n(i, tid) : acc_m(i, tid);
    const int c = SWAP ? acc_m(i, tid) : acc_n(i, tid);
    if (r < nrows && c < ncols)
      y[y_off[r] + d0 + c] = __float2bfloat16_rn(acc[i]);
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <bool SWAP>
int launch_wgmma(const void* x, const void* w_in, const void* w_out, void* y,
                 void* h3, int BC, int E, int C, int D, int F,
                 cudaStream_t stream) {
  using U = UpTile<SWAP>;
  using W = DownTile<SWAP>;
  int err = set_smem(moe_up_wgmma_kernel<SWAP>, tile_smem<U>());
  if (err) return err;
  err = set_smem(moe_down_wgmma_kernel<SWAP>, tile_smem<W>());
  if (err) return err;
  const dim3 up((BC + U::ROWS - 1) / U::ROWS, (F + U::COLS - 1) / U::COLS, E);
  moe_up_wgmma_kernel<SWAP><<<up, tc::WG_THREADS, tile_smem<U>(), stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w_in),
      static_cast<bf16*>(h3), BC, E, C, D, F);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 down((BC + W::ROWS - 1) / W::ROWS, (D + W::COLS - 1) / W::COLS,
                  E);
  moe_down_wgmma_kernel<SWAP>
      <<<down, tc::WG_THREADS, tile_smem<W>(), stream>>>(
          static_cast<const bf16*>(h3), static_cast<const bf16*>(w_out),
          static_cast<bf16*>(y), BC, E, C, D, F);
  return (int)cudaGetLastError();
}

template <bool SWAP>
void plan_wgmma(int BC, int E, int D, int F, int* out) {
  using U = UpTile<SWAP>;
  using W = DownTile<SWAP>;
  const int tiles[2][3] = {{U::ROWS, U::COLS, (F + U::COLS - 1) / U::COLS},
                           {W::ROWS, W::COLS, (D + W::COLS - 1) / W::COLS}};
  for (int l = 0; l < 2; ++l) {
    out[3 + 4 * l] = tiles[l][0];
    out[4 + 4 * l] = tiles[l][1];
    out[5 + 4 * l] = (BC + tiles[l][0] - 1) / tiles[l][0] * tiles[l][2] * E;
    out[6 + 4 * l] = (int)(l ? tile_smem<W>() : tile_smem<U>());
  }
}

}  // namespace

// Rows per CTA the launch takes for these shapes (16, 8 or 4), or 0 when
// not even 4 rows of x and of the hidden tile fit in shared memory.
extern "C" int moe_expert_ffn_rows(int BC, int E, int D, int F) {
  int dev = 0, optin = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  const long long blocks16 = (long long)E * ((BC + 15) / 16);
  if (smem_bytes(16, D, F) <= (size_t)optin && blocks16 >= 2LL * sms)
    return 16;
  if (smem_bytes(8, D, F) <= (size_t)optin) return 8;
  if (smem_bytes(4, D, F) <= (size_t)optin) return 4;
  return 0;
}

bool valid(int dtype, long long bc, int E, int D, int F) {
  return bc > 0 && bc <= 0x7fffffffLL && E > 0 && E <= 65535 && D > 0 &&
         F > 0 && D % 4 == 0 && F % 4 == 0 && (dtype == 0 || dtype == 1);
}

// What a call of these shapes launches: out[0] the path (0: the float32
// FMA body, 1: the bf16 wgmma kernels), out[1] 1 when the bf16 tiles are
// swapped (weights in M, B*C <= 32 token rows in N), out[2] the number of
// launches; then per launch out[3 + 4 l ..]: token rows and columns of a
// tile, CTAs, dynamic shared bytes per CTA (the FMA body: rows per CTA, D,
// CTAs, shared bytes). Returns a cudaError_t.
extern "C" int moe_expert_ffn_plan(int dtype, int B, int E, int C, int D,
                                   int F, int* out) {
  const long long bc = (long long)B * C;
  if (!valid(dtype, bc, E, D, F)) return (int)cudaErrorInvalidValue;
  const int BC = (int)bc;
  for (int i = 0; i < 11; ++i) out[i] = 0;
  out[0] = dtype;
  out[1] = dtype == 1 && BC <= SWAP_ROWS;
  out[2] = dtype == 1 ? 2 : 1;
  if (dtype == 1) {
    if (out[1]) plan_wgmma<true>(BC, E, D, F, out);
    else plan_wgmma<false>(BC, E, D, F, out);
    return 0;
  }
  const int rows = moe_expert_ffn_rows(BC, E, D, F);
  out[3] = rows;
  out[4] = D;
  out[5] = rows ? (BC + rows - 1) / rows * E : 0;
  out[6] = (int)smem_bytes(rows, D, F);
  return 0;
}

// dtype 0: float32 (the FMA body, one launch), 1: bfloat16 (the wgmma
// kernels, two launches; h3 is bf16 scratch of 3 * B * C * E * F elements).
// Returns a cudaError_t.
extern "C" int moe_expert_ffn_launch(int dtype, const void* x,
                                     const void* w_in, const void* w_out,
                                     void* y, void* h3, int B, int E, int C,
                                     int D, int F, void* stream) {
  const long long bc = (long long)B * C;
  if (!valid(dtype, bc, E, D, F) || (dtype == 1 && h3 == nullptr))
    return (int)cudaErrorInvalidValue;
  const int BC = (int)bc;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return BC <= SWAP_ROWS
               ? launch_wgmma<true>(x, w_in, w_out, y, h3, BC, E, C, D, F, s)
               : launch_wgmma<false>(x, w_in, w_out, y, h3, BC, E, C, D, F,
                                     s);
  switch (moe_expert_ffn_rows(BC, E, D, F)) {
    case 16: return launch_rows<float, 16>(x, w_in, w_out, y, BC, E, C, D, F, s);
    case 8: return launch_rows<float, 8>(x, w_in, w_out, y, BC, E, C, D, F, s);
    case 4: return launch_rows<float, 4>(x, w_in, w_out, y, BC, E, C, D, F, s);
  }
  return (int)cudaErrorInvalidValue;
}
