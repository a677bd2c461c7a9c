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
// Din 16384, N 16, float32) the launch moves ~0.8 GB (dt, x, y), a byte
// bound of ~0.24 ms. But every (t, c, n) costs a full-precision expf (no
// fast math: ~8 instructions with one MUFU.EX2) and four more, ~12 issue
// slots, so 1.07e9 of them are ~4e8 warp instructions over 528
// schedulers: ~0.4 ms of issue.
//
// The first version (one thread per (batch, channel), 128-channel CTAs,
// 32-step blocks in static shared memory) took 1.83-1.84 ms there on an
// H100 SXM, 13% of the byte bound:
//   (1) staging was synchronous: each block's dt and x came through a
//       runtime-length loop of dependent global loads and shared stores,
//       B_t and C_t through a second one, between two barriers; no step
//       ran on the SM while a block loaded (64 times at T = 2048);
//   (2) the step loop and the served N ran through runtime bounds and
//       n < N predicates, so consecutive steps' independent work (a
//       step's expfs do not depend on h) was not interleaved;
//   (3) each thread read its A and h0 rows and wrote its hT row as N
//       scalar accesses at an N-float stride across the warp: at T = 1
//       that is the whole launch (11.3 us against 1.7 us of bytes).
// This design keeps the arithmetic, and so the bits, of that kernel:
//
//   * (1) blocks of TB = 32 steps are staged by cp.async, 16-byte copies,
//     one commit group a block, double-buffered: block n + 1's dt, x (in
//     their own type; bf16 is converted where a step reads it, exactly),
//     B_t and C_t land while block n's steps run, one barrier a block.
//     Rows that are not whole 16-byte chunks or not 16-byte aligned (Din
//     70 in bf16, N 5) are staged by plain loads, eight in flight a
//     thread, on the same schedule;
//   * (2) a full block runs TB compile-time steps, unrolled by 4, so the
//     scheduler overlaps one step's expfs with the previous step's C-dot
//     chain; the served N = 16 has its own instantiation with no n < N
//     predicates (NMAX 16 and 32 keep them for other N); only a ragged
//     last block runs a runtime loop;
//   * (3) A and h0 rows are read, and hT rows written, as float4 where
//     N % 4 == 0 and the pointers allow (else N scalar accesses a thread,
//     as before); block 0's copies are in flight while the state loads;
//   * 128 channels a CTA (256 CTAs at the served shape, 2 an SM, 73.7 KB
//     of shared memory each);
//   * per channel, unchanged: one thread per (batch, channel) with its N
//     states and its A row in registers; each contraction is written out
//     as the first version's code compiled: a_bar = expf(dt * A[n]),
//     h = fmaf(a_bar, h, (dt * x) * B[n]), the C dot an fmaf chain in n
//     order from 0, y = fmaf(D, x, dot).
// What still bounds it: the issue slots of the expfs (~0.4 ms at the
// served shape), then the 8 SMs that hold one CTA where the others hold
// two; at T = 1, the latency of one state read, one block copy and one
// state write.
//
// No float atomics: every y element and every state entry is owned by one
// thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TB = 32;          // time steps staged per block
constexpr int CH = 128;         // channels (threads) of a CTA
constexpr int LOADS = 8;        // plain loads in flight a thread

// Shared memory: dt and x [2][TB][CH] in their own type, then B_t and C_t
// [2][TB][NMAX] float32, all double-buffered. Every part is a multiple of
// 16 bytes.
__host__ __device__ constexpr int smem_bytes(int elt, int nmax) {
  return 2 * TB * (2 * CH * elt + 2 * nmax * 4);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// *p = v where live, as one predicated store: an `if` around a plain store
// compiles to a branch that would end the unrolled steps' basic block.
__device__ __forceinline__ void store_if(float* p, float v, bool live) {
  asm volatile("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t"
               "@q st.global.f32 [%0], %1;\n\t}\n"
               :: "l"(p), "f"(v), "r"((int)live));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// nt rows of `width` elements (width <= W) into a [TB][W] buffer: element
// i of row tt is read at src(tt, i) and written at dst(tt, i). With
// async_rows (rows of whole 16-byte chunks at 16-byte aligned addresses)
// by cp.async, a chunk a copy; else by plain loads, LOADS in flight a
// thread. The CTA walks the whole [TB][W] grid, so every trip count is a
// compile-time constant.
template <int W, typename Elt, typename Src, typename Dst>
__device__ __forceinline__ void stage_rows(bool async_rows, int nt,
                                           int width, Src src, Dst dst) {
  const int tid = threadIdx.x;
  if (async_rows) {
    constexpr int EPC = 16 / sizeof(Elt);      // elements a chunk
    constexpr int CPR = W / EPC;               // chunks a row
    static_assert(TB * CPR % CH == 0, "whole copies a thread");
#pragma unroll
    for (int k = 0; k < TB * CPR / CH; ++k) {
      const int idx = k * CH + tid;
      const int tt = idx / CPR, i = idx % CPR * EPC;
      if (tt < nt && i < width) cp_async16(dst(tt, i), src(tt, i));
    }
  } else {
    constexpr int PER = TB * W / CH;           // elements a thread
    constexpr int U = PER < LOADS ? PER : LOADS;
    static_assert(PER % U == 0, "whole batches of loads");
#pragma unroll
    for (int k0 = 0; k0 < PER; k0 += U) {
      Elt v[U];
#pragma unroll
      for (int e = 0; e < U; ++e) {
        const int idx = (k0 + e) * CH + tid, tt = idx / W, i = idx % W;
        if (tt < nt && i < width) v[e] = *src(tt, i);
      }
#pragma unroll
      for (int e = 0; e < U; ++e) {
        const int idx = (k0 + e) * CH + tid, tt = idx / W, i = idx % W;
        if (tt < nt && i < width) *dst(tt, i) = v[e];
      }
    }
  }
}

// One step of one channel: updates h and returns the C dot. The
// contractions are spelled out as the first version's code compiled, so
// that no restructuring can move a rounding.
template <int NMAX, bool FULL_N>
__device__ __forceinline__ float scan_step(float (&h)[NMAX],
                                           const float (&av)[NMAX],
                                           float dtv, float xv,
                                           const float* brow,
                                           const float* crow, int N) {
  const float dx = __fmul_rn(dtv, xv);
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < NMAX / 4; ++q) {
    if (FULL_N || 4 * q < N) {
      const float4 b4 = *reinterpret_cast<const float4*>(brow + 4 * q);
      const float4 c4 = *reinterpret_cast<const float4*>(crow + 4 * q);
      const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
      const float cc[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 4 * q + e;
        if (FULL_N || n < N) {
          const float a_bar = expf(__fmul_rn(dtv, av[n]));
          h[n] = __fmaf_rn(a_bar, h[n], __fmul_rn(dx, bb[e]));
          acc = __fmaf_rn(h[n], cc[e], acc);
        }
      }
    }
  }
  return acc;
}

template <typename Elt, int NMAX, bool FULL_N>
__global__ void __launch_bounds__(CH)
mamba_scan_kernel(const Elt* __restrict__ dt, const Elt* __restrict__ x,
                  const float* __restrict__ bm, const float* __restrict__ cm,
                  const float* __restrict__ a, const float* __restrict__ d,
                  const float* __restrict__ h0, float* __restrict__ y,
                  float* __restrict__ hT, int Tlen, int Din, int N,
                  int async_rows, int async_bc, int vec_state) {
  extern __shared__ __align__(16) unsigned char smem[];
  Elt* dts = reinterpret_cast<Elt*>(smem);                  // [2][TB][CH]
  Elt* xs = dts + 2 * TB * CH;                              // [2][TB][CH]
  float* bs = reinterpret_cast<float*>(xs + 2 * TB * CH);   // [2][TB][NMAX]
  float* cs = bs + 2 * TB * NMAX;                           // [2][TB][NMAX]

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * CH, b = blockIdx.y;
  const int c = c0 + tid;
  const bool live_c = c < Din;
  const int ncols = min(CH, Din - c0);
  const long long row0 = (long long)b * Tlen;              // (b, t = 0)
  const long long srow = (long long)b * Din + c;           // (b, c) state

  auto stage = [&](int t0, int nt, int sb) {
    const long long off = (row0 + t0) * Din + c0;
    const Elt *dtg = dt + off, *xg = x + off;
    const float *bg = bm + (row0 + t0) * N, *cg = cm + (row0 + t0) * N;
    Elt *dtd = dts + sb * TB * CH, *xd = xs + sb * TB * CH;
    float *bd = bs + sb * TB * NMAX, *cd = cs + sb * TB * NMAX;
    stage_rows<CH, Elt>(
        async_rows, nt, ncols,
        [&](int tt, int i) { return dtg + (long long)tt * Din + i; },
        [&](int tt, int i) { return dtd + tt * CH + i; });
    stage_rows<CH, Elt>(
        async_rows, nt, ncols,
        [&](int tt, int i) { return xg + (long long)tt * Din + i; },
        [&](int tt, int i) { return xd + tt * CH + i; });
    stage_rows<NMAX, float>(
        async_bc, nt, N, [&](int tt, int i) { return bg + tt * N + i; },
        [&](int tt, int i) { return bd + tt * NMAX + i; });
    stage_rows<NMAX, float>(
        async_bc, nt, N, [&](int tt, int i) { return cg + tt * N + i; },
        [&](int tt, int i) { return cd + tt * NMAX + i; });
    cp_async_commit();
  };
  const int nblocks = (Tlen + TB - 1) / TB;
  stage(0, min(TB, Tlen), 0);                  // in flight with the state

  float h[NMAX], av[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) h[n] = av[n] = 0.0f;
  if (vec_state) {                             // N % 4 == 0, 16-byte rows
#pragma unroll
    for (int q = 0; q < NMAX / 4; ++q)
      if (live_c && (FULL_N || 4 * q < N)) {
        const float4 a4 = *reinterpret_cast<const float4*>(
            a + (long long)c * N + 4 * q);
        av[4 * q] = a4.x; av[4 * q + 1] = a4.y;
        av[4 * q + 2] = a4.z; av[4 * q + 3] = a4.w;
        if (h0 != nullptr) {
          const float4 h4 = *reinterpret_cast<const float4*>(
              h0 + srow * N + 4 * q);
          h[4 * q] = h4.x; h[4 * q + 1] = h4.y;
          h[4 * q + 2] = h4.z; h[4 * q + 3] = h4.w;
        }
      }
  } else {
#pragma unroll
    for (int n = 0; n < NMAX; ++n)
      if (live_c && n < N) {
        av[n] = a[(long long)c * N + n];
        if (h0 != nullptr) h[n] = h0[srow * N + n];
      }
  }
  const float dc = live_c ? d[c] : 0.0f;

  for (int blk = 0; blk < nblocks; ++blk) {
    const int t0 = blk * TB, nt = min(TB, Tlen - t0), cur = blk & 1;
    cp_async_wait_all();
    __syncthreads();          // block blk has landed; blk - 1 is consumed
    if (blk + 1 < nblocks) stage(t0 + TB, min(TB, Tlen - t0 - TB), cur ^ 1);
    const Elt* dtb = dts + cur * TB * CH + tid;
    const Elt* xb = xs + cur * TB * CH + tid;
    const float* bb = bs + cur * TB * NMAX;
    const float* cb = cs + cur * TB * NMAX;
    float* yb = y + (row0 + t0) * Din + c;
    auto step = [&](int tt) {
      const float dtv = to_f32(dtb[tt * CH]), xv = to_f32(xb[tt * CH]);
      const float acc = scan_step<NMAX, FULL_N>(h, av, dtv, xv,
                                                bb + tt * NMAX,
                                                cb + tt * NMAX, N);
      store_if(yb + (long long)tt * Din, __fmaf_rn(dc, xv, acc), live_c);
    };
    if (nt == TB) {                  // 4 steps unrolled together
#pragma unroll 4
      for (int tt = 0; tt < TB; ++tt) step(tt);
    } else {
#pragma unroll 1
      for (int tt = 0; tt < nt; ++tt) step(tt);
    }
  }

  if (vec_state) {
#pragma unroll
    for (int q = 0; q < NMAX / 4; ++q)
      if (live_c && (FULL_N || 4 * q < N))
        *reinterpret_cast<float4*>(hT + srow * N + 4 * q) =
            make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
  } else {
#pragma unroll
    for (int n = 0; n < NMAX; ++n)
      if (live_c && n < N) hT[srow * N + n] = h[n];
  }
}

struct Plan {
  int nx, nmax, full_n, async_rows, async_bc, vec_state;
  long long ctas;
};

// The launch's shape: ceil(Din / CH) x B CTAs; dt and x go by cp.async
// when their rows are whole 16-byte chunks, B_t and C_t when N % 4 == 0,
// the state rows as float4 when N % 4 == 0 (the launch also checks that
// the base pointers are 16-byte aligned).
Plan make_plan(int dtype, int B, int Din, int N) {
  const int elt = dtype == 1 ? 2 : 4;
  Plan p;
  p.nx = (Din + CH - 1) / CH;
  p.ctas = (long long)B * p.nx;
  p.nmax = N <= 16 ? 16 : 32;
  p.full_n = N == 16;
  p.async_rows = ((long long)Din * elt) % 16 == 0;
  p.async_bc = N % 4 == 0;
  p.vec_state = N % 4 == 0;
  return p;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

template <typename Elt, int NMAX, bool FULL_N>
int launch(const Plan& p, const void* dt, const void* x, const float* bm,
           const float* cm, const float* a, const float* d, const float* h0,
           float* y, float* hT, int B, int T, int Din, int N,
           cudaStream_t stream) {
  const int async_rows = p.async_rows && aligned16(dt) && aligned16(x);
  const int async_bc = p.async_bc && aligned16(bm) && aligned16(cm);
  const int vec_state = p.vec_state && aligned16(a) && aligned16(hT) &&
                        (h0 == nullptr || aligned16(h0));
  const int smem = smem_bytes(sizeof(Elt), NMAX);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mamba_scan_kernel<Elt, NMAX, FULL_N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(p.nx, B);
  mamba_scan_kernel<Elt, NMAX, FULL_N><<<grid, CH, smem, stream>>>(
      static_cast<const Elt*>(dt), static_cast<const Elt*>(x), bm, cm, a, d,
      h0, y, hT, T, Din, N, async_rows, async_bc, vec_state);
  return (int)cudaGetLastError();
}

template <typename Elt>
int dispatch(const Plan& p, const void* dt, const void* x, const float* bm,
             const float* cm, const float* a, const float* d,
             const float* h0, float* y, float* hT, int B, int T, int Din,
             int N, cudaStream_t s) {
  if (p.full_n)
    return launch<Elt, 16, true>(p, dt, x, bm, cm, a, d, h0, y, hT, B, T,
                                 Din, N, s);
  if (p.nmax == 16)
    return launch<Elt, 16, false>(p, dt, x, bm, cm, a, d, h0, y, hT, B, T,
                                  Din, N, s);
  return launch<Elt, 32, false>(p, dt, x, bm, cm, a, d, h0, y, hT, B, T,
                                Din, N, s);
}

bool valid(int dtype, int B, int T, int Din, int N) {
  return B > 0 && B <= 65535 && T > 0 && Din > 0 && N > 0 && N <= 32 &&
         (dtype == 0 || dtype == 1);
}

}  // namespace

// N <= 32. dtype (of dt and x) 0: float32, 1: bfloat16; every other
// pointer is float32, h0 may be null. Returns a cudaError_t.
extern "C" int mamba_scan_launch(int dtype, const void* dt, const void* x,
                                 const float* bm, const float* cm,
                                 const float* a, const float* d,
                                 const float* h0, float* y, float* hT, int B,
                                 int T, int Din, int N, void* stream) {
  if (!valid(dtype, B, T, Din, N)) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(dtype, B, Din, N);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(p, dt, x, bm, cm, a, d, h0, y, hT, B, T, Din, N,
                           s);
  return dispatch<__nv_bfloat16>(p, dt, x, bm, cm, a, d, h0, y, hT, B, T, Din,
                                 N, s);
}

// What mamba_scan_launch launches for these sizes: out[0] CTAs, out[1]
// threads per CTA (= out[2], the channels of a CTA), out[3] TB, out[4] 1
// when dt and x are staged by cp.async (0: plain loads), out[5] dynamic
// shared bytes per CTA, out[6] NMAX, out[7] 1 for the instantiation of
// N = 16 exactly (no n < N predicates), out[8] 1 when B_t and C_t are
// staged by cp.async, out[9] 1 when the state rows are read and written as
// float4 (0: N scalar accesses a thread). A launch whose base pointers
// are not 16-byte aligned takes the plain routes for them. Returns a
// cudaError_t.
extern "C" int mamba_scan_plan(int dtype, int B, int T, int Din, int N,
                               int* out) {
  if (!valid(dtype, B, T, Din, N)) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(dtype, B, Din, N);
  out[0] = (int)p.ctas;
  out[1] = CH;
  out[2] = CH;
  out[3] = TB;
  out[4] = p.async_rows;
  out[5] = smem_bytes(dtype == 1 ? 2 : 4, p.nmax);
  out[6] = p.nmax;
  out[7] = p.full_n;
  out[8] = p.async_bc;
  out[9] = p.vec_state;
  return 0;
}
