// Fused MoE expert FFN for Hopper: y = (silu(x W_in[:, :F]) * x W_in[:, F:]) W_out
// per expert, float32 inside, the hidden activations never in device memory.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_experts.py
// (moe_expert_ffn, body _kernel), which runs one grid program per
// (expert, capacity block) of one sequence and is vmapped over the batch.
// Here one launch covers the whole batch: x is [B, E, C, D] (or [E, C, D],
// B = 1), w_in [E, D, 2F], w_out [E, F, D], y has x's shape and dtype; C
// is taken unpadded. bf16 and float32 inputs are both upcast to float32,
// as the TPU body does; y is rounded once to x's type.
//
// What bounds it on this card: at a 4 x 512-token prefill (C = 129) the
// launch does ~97 GFLOP against ~316 MB, operation-bound even at the bf16
// tensor-core rate; a decode step (C = 8) moves the 189 MB of expert
// weights for ~6 GFLOP, byte-bound. This first kernel is simple and runs on
// the float32 FMA units:
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

namespace {

constexpr int THREADS = 256;
constexpr int KC = 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
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

// dtype 0: float32, 1: bfloat16. Returns a cudaError_t.
extern "C" int moe_expert_ffn_launch(int dtype, const void* x,
                                     const void* w_in, const void* w_out,
                                     void* y, int B, int E, int C, int D,
                                     int F, void* stream) {
  const long long bc = (long long)B * C;
  if (bc <= 0 || bc > 0x7fffffffLL || E <= 0 || E > 65535 || D % 4 ||
      F % 4 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int BC = (int)bc;
  const int rows = moe_expert_ffn_rows(BC, E, D, F);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    switch (rows) {
      case 16: return launch_rows<float, 16>(x, w_in, w_out, y, BC, E, C, D, F, s);
      case 8: return launch_rows<float, 8>(x, w_in, w_out, y, BC, E, C, D, F, s);
      case 4: return launch_rows<float, 4>(x, w_in, w_out, y, BC, E, C, D, F, s);
    }
  } else {
    switch (rows) {
      case 16: return launch_rows<__nv_bfloat16, 16>(x, w_in, w_out, y, BC, E, C, D, F, s);
      case 8: return launch_rows<__nv_bfloat16, 8>(x, w_in, w_out, y, BC, E, C, D, F, s);
      case 4: return launch_rows<__nv_bfloat16, 4>(x, w_in, w_out, y, BC, E, C, D, F, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}
