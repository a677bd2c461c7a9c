// Selective-SSM (Mamba) scan with ZOH discretization for Hopper, float32
// state.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan.py
// (mamba_selective_scan, body _kernel), whose grid (batch, channel block,
// time block) keeps the [BD, N] float32 state in VMEM scratch across the
// sequential time blocks. Per channel c with state h [N]:
//
//   a_bar = exp(dt_t[c] * A[c])                (in registers, every step)
//   h     = a_bar * h + (dt_t[c] * x_t[c]) * B_t
//   y_t[c] = h . C_t + D[c] * x_t[c]
//
// dt, x are [B, T, Din] in float32 or bfloat16 (one type); B_t, C_t
// [B, T, N], A [Din, N] (negative) and D [Din] are float32. The launch
// reads an optional initial state h0 [B, Din, N] (null: zeros) and writes
// y [B, T, Din] and the final state hT [B, Din, N], both float32; y
// includes D * x, as the TPU body's does.
//
// What bounds it on this card: at Jamba's Mamba block (B 2, T 2048,
// Din 16384, N 16, float32) the launch reads and writes ~0.8 GB of dt, x
// and y, a byte bound of ~0.24 ms; its ~1.1e9 expf and ~6 GFLOP are
// below that. So every input element is read once and every output
// written once:
//
//   * one thread per (batch, channel) walks the sequence with its N-long
//     state and its row of A in registers (NMAX slots; n >= N skipped);
//   * a CTA holds 128 neighbouring channels of one sequence; per pass it
//     stages TB steps of dt and x (coalesced along channels) and of B_t
//     and C_t (shared by all its channels) in shared memory;
//   * y_t is written coalesced along channels, the state once at the end.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;   // channels per CTA
constexpr int TB = 32;         // time steps staged per pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename Elt, int NMAX>
__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const Elt* __restrict__ dt, const Elt* __restrict__ x,
                  const float* __restrict__ bm, const float* __restrict__ cm,
                  const float* __restrict__ a, const float* __restrict__ d,
                  const float* __restrict__ h0, float* __restrict__ y,
                  float* __restrict__ hT, int Tlen, int Din, int N) {
  __shared__ float dts[TB][THREADS];
  __shared__ float xs[TB][THREADS];
  __shared__ float bs[TB][NMAX];
  __shared__ float cs[TB][NMAX];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * THREADS, b = blockIdx.y;
  const int c = c0 + tid;
  const bool live_c = c < Din;

  float h[NMAX], av[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    const bool live = live_c && n < N;
    av[n] = live ? a[(long long)c * N + n] : 0.0f;
    h[n] = (live && h0 != nullptr) ? h0[((long long)b * Din + c) * N + n]
                                   : 0.0f;
  }
  const float dc = live_c ? d[c] : 0.0f;

  for (int t0 = 0; t0 < Tlen; t0 += TB) {
    const int nt = min(TB, Tlen - t0);
    __syncthreads();                      // the previous pass is consumed
    for (int tt = 0; tt < nt; ++tt) {
      const long long off = ((long long)b * Tlen + t0 + tt) * Din + c;
      dts[tt][tid] = live_c ? to_f32(dt[off]) : 0.0f;
      xs[tt][tid] = live_c ? to_f32(x[off]) : 0.0f;
    }
    for (int idx = tid; idx < nt * NMAX; idx += THREADS) {
      const int tt = idx / NMAX, n = idx - tt * NMAX;
      const long long off = ((long long)b * Tlen + t0 + tt) * N + n;
      bs[tt][n] = n < N ? bm[off] : 0.0f;
      cs[tt][n] = n < N ? cm[off] : 0.0f;
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float dtv = dts[tt][tid], xv = xs[tt][tid];
      const float dx = dtv * xv;
      float acc = 0.0f;
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n < N) {
          const float a_bar = expf(dtv * av[n]);
          h[n] = a_bar * h[n] + dx * bs[tt][n];
          acc = fmaf(h[n], cs[tt][n], acc);
        }
      }
      if (live_c)
        y[((long long)b * Tlen + t0 + tt) * Din + c] = acc + dc * xv;
    }
  }

  if (live_c) {
#pragma unroll
    for (int n = 0; n < NMAX; ++n)
      if (n < N) hT[((long long)b * Din + c) * N + n] = h[n];
  }
}

template <typename Elt, int NMAX>
int launch(const void* dt, const void* x, const float* bm, const float* cm,
           const float* a, const float* d, const float* h0, float* y,
           float* hT, int B, int T, int Din, int N, cudaStream_t stream) {
  const dim3 grid((Din + THREADS - 1) / THREADS, B);
  mamba_scan_kernel<Elt, NMAX><<<grid, THREADS, 0, stream>>>(
      static_cast<const Elt*>(dt), static_cast<const Elt*>(x), bm, cm, a, d, h0,
      y, hT, T, Din, N);
  return (int)cudaGetLastError();
}

template <typename Elt>
int dispatch(const void* dt, const void* x, const float* bm, const float* cm,
             const float* a, const float* d, const float* h0, float* y,
             float* hT, int B, int T, int Din, int N, cudaStream_t s) {
  if (N <= 16)
    return launch<Elt, 16>(dt, x, bm, cm, a, d, h0, y, hT, B, T, Din, N, s);
  return launch<Elt, 32>(dt, x, bm, cm, a, d, h0, y, hT, B, T, Din, N, s);
}

}  // namespace

// N <= 32. dtype (of dt and x) 0: float32, 1: bfloat16; every other
// pointer is float32, h0 may be null. Returns a cudaError_t.
extern "C" int mamba_scan_launch(int dtype, const void* dt, const void* x,
                                 const float* bm, const float* cm,
                                 const float* a, const float* d,
                                 const float* h0, float* y, float* hT, int B,
                                 int T, int Din, int N, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || Din <= 0 || N <= 0 || N > 32 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(dt, x, bm, cm, a, d, h0, y, hT, B, T, Din, N, s);
  return dispatch<__nv_bfloat16>(dt, x, bm, cm, a, d, h0, y, hT, B, T, Din,
                                 N, s);
}
