// RWKV-6 (Finch) WKV recurrence for Hopper, float32 state.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6.py (wkv6, body
// _kernel), whose grid (batch, head, time block) keeps the [K, V] float32
// state in VMEM scratch across the sequential time blocks. Per head:
//
//   o_t[j]  = sum_i r_t[i] S[i][j] + (sum_i r_t[i] u[i] k_t[i]) v_t[j]
//   S[i][j] = w_t[i] S[i][j] + k_t[i] v_t[j]
//
// r, k, v are [B, T, H, K|V] in float32 or bfloat16 (one type), w is
// [B, T, H, K] float32 (the model's decay exp(-exp(.)) is float32), u is
// [H, K] float32. The launch reads an optional initial state s0
// [B, H, K, V] (null: zeros) and writes the final state sT [B, H, K, V]
// and o [B, T, H, V], both float32; the wrapper rounds o to bf16 when the
// caller asks for it (one rounding, as the TPU body's astype).
//
// What bounds it on this card: at the served shape (B 4, T 512, H 64,
// K = V = 64) the launch does ~2.7 GFLOP (5 K V flops per token and head)
// against ~122 MB (r, k, v in bf16, w and o in float32, the state), ~41 us
// at the float32 rate and ~36 us at the memory rate. Time is sequential,
// so each head's state is spread over many threads, and what limits the
// kernel is how fast each step's operands reach them.
//
// The first version (one CTA of 4 V threads per (batch, head), 16-step
// blocks) took 0.57 ms there on an H100 SXM, 7% of its bound:
//   (1) staging was serialised: each block of r, k, w, v was copied by a
//       strided loop of dependent global loads and shared stores, and the
//       step loop waited at a barrier for all of it;
//   (2) 256 CTAs of 256 threads, 2 on each of the 132 SMs, hid nothing;
//   (3) __launch_bounds__(1024) capped every thread at 64 registers;
//   (4) a step's 16-byte loads of r, k and w put quarters 0 and 2 (and 1
//       and 3) of a row in the same banks: 8 shared-memory wavefronts a
//       load, the limit once (1)-(3) are gone.
// This design keeps the arithmetic, and so the bits, of that kernel:
//
//   * (1) time blocks of TB steps (32 for bf16 rows of up to 64, else 16)
//     are staged by cp.async, 16-byte copies, one commit group a block:
//     w and v double-buffered, so that block n + 1's copies land while
//     block n's steps run; r and k in their own type, converted once to
//     float32 by a pass that also reduces each step's bonus r.(u*k) (one
//     warp a step, PB steps at once): two barriers a block. Rows that are
//     not whole 16-byte chunks or not 16-byte aligned (K 5 or 12 in bf16,
//     V 3) are staged by plain loads, four in flight a thread, on the
//     same schedule;
//   * (2) the value columns are split: a CTA owns VB (64, 32 or 16)
//     columns of one head's state, the widest that gives at least 2 CTAs
//     an SM (512 CTAs at the served shape), and stages its head's r, k, w
//     itself (the second read comes from L2); every CTA of a head reduces
//     the same bonus in the same lane order;
//   * (3) each instantiation is bounded by its own block (2 VB threads,
//     one CTA an SM at least): up to 255 registers, no spills;
//   * (4) the float32 operand rows carry 4 unused floats after each
//     quarter, so a quarter-warp's 16-byte loads fall in 4 bank groups (4
//     wavefronts), and a thread owns two columns, j and j + VB / 2, which
//     share its loads of r, k and w: a quarter of the first version's
//     shared-memory traffic per column.
//   * Per column, unchanged: thread (j, quarter q) holds rows
//     q*KQ .. q*KQ+KQ-1 of column j in registers (KQ = KMAX / 4; rows
//     K..KMAX-1 stay zero); KQ fused multiply-adds into four partial sums
//     for r.S and KQ for the update fmaf(w, s, k * v); the partial sums
//     are added as (a0 + a1) + (a2 + a3) and the four quarters with two
//     xor-shuffles (1, then 2); o = dot + bonus * v.
// What still bounds it: the shared-memory wavefronts of the step loads (a
// quarter-warp's load brings 4 distinct 16-byte chunks, half of what a
// wavefront carries) and the instruction count of the step arithmetic,
// then the bonus pass between a block's barriers; at T = 1, the latency
// of one state read, one block copy and one state write.
//
// No float atomics: o_t[j] and every state entry are owned by one thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int KSPLIT = 4;   // threads per state column
constexpr int COLS = 2;     // state columns per thread
constexpr int VB_MIN = 8 * COLS;   // narrowest CTA: one warp
constexpr int PB = 4;       // steps whose bonus a warp reduces at once

// Time steps staged per block: 32 for bf16 rows of up to 64, else 16 (a
// CTA's shared memory stays under 57 KB, so 4 fit on an SM).
__host__ __device__ constexpr int time_block(int elt, int kmax) {
  return elt == 2 && kmax <= 64 ? 32 : 16;
}

// Row stride of the float32 operands the steps read: each quarter of
// KQ = KMAX / 4 rows is followed by 4 unused floats, so the four quarters'
// 16-byte loads of one step fall in four different bank groups.
__host__ __device__ constexpr int padded_k(int kmax) { return kmax + 16; }

// Shared memory: w [2][TB][KP] float32 and v [2][TB][VB] (double-buffered),
// r and k [TB][KMAX] in their own type as copied, r and k [TB][KP] as
// float32, u [KMAX], the bonus [TB]. Every part is a multiple of 16 bytes.
__host__ __device__ constexpr int smem_bytes(int elt, int kmax, int vb) {
  return time_block(elt, kmax)
             * (4 * padded_k(kmax) * 4 + 2 * vb * elt + 2 * kmax * elt + 4)
         + 4 * kmax;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

// nt rows of `width` elements, as 16-byte copies: src(tt, i) and dst(tt, i)
// address element i of row tt.
template <int NT, typename Elt, typename Src, typename Dst>
__device__ __forceinline__ void copy_rows(int nt, int width, Src src,
                                          Dst dst) {
  constexpr int EPC = 16 / sizeof(Elt);
  const int chunks = width / EPC;
  for (int c = threadIdx.x; c < nt * chunks; c += NT) {
    const int tt = c / chunks, i = (c - tt * chunks) * EPC;
    cp_async16(dst(tt, i), src(tt, i));
  }
}

// The same rows by plain loads, four independent loads in flight a thread.
template <int NT, typename Elt, typename Src, typename Dst>
__device__ __forceinline__ void load_rows(int nt, int width, Src src,
                                          Dst dst) {
  constexpr int U = 4;
  for (int base = threadIdx.x; base < nt * width; base += U * NT) {
    Elt val[U];
#pragma unroll
    for (int e = 0; e < U; ++e) {
      const int idx = base + e * NT;
      if (idx < nt * width) {
        const int tt = idx / width;
        val[e] = *src(tt, idx - tt * width);
      }
    }
#pragma unroll
    for (int e = 0; e < U; ++e) {
      const int idx = base + e * NT;
      if (idx < nt * width) {
        const int tt = idx / width;
        *dst(tt, idx - tt * width) = val[e];
      }
    }
  }
}

template <int NT, typename Elt, typename Src, typename Dst>
__device__ __forceinline__ void stage_rows(bool async_rows, int nt,
                                           int width, Src src, Dst dst) {
  if (async_rows)
    copy_rows<NT, Elt>(nt, width, src, dst);
  else
    load_rows<NT, Elt>(nt, width, src, dst);
}

template <typename Elt, int KMAX, int VB>
__global__ void __launch_bounds__(KSPLIT * VB / COLS, 1)
wkv6_kernel(const Elt* __restrict__ r, const Elt* __restrict__ k,
            const Elt* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ o, float* __restrict__ sT, int Tlen, int H,
            int K, int V, int nvb, int async_rows) {
  constexpr int ELT = sizeof(Elt);
  constexpr int TB = time_block(ELT, KMAX);
  constexpr int KQ = KMAX / KSPLIT, KP = padded_k(KMAX);
  constexpr int HALF = VB / COLS;            // a thread's columns jl + c HALF
  constexpr int NT = KSPLIT * HALF, NWARPS = NT / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* wbuf = reinterpret_cast<float*>(smem);            // [2][TB][KP]
  Elt* vbuf = reinterpret_cast<Elt*>(wbuf + 2 * TB * KP);  // [2][TB][VB]
  Elt* rraw = vbuf + 2 * TB * VB;                          // [TB][KMAX]
  Elt* kraw = rraw + TB * KMAX;                            // [TB][KMAX]
  float* rf = reinterpret_cast<float*>(kraw + TB * KMAX);  // [TB][KP]
  float* kf = rf + TB * KP;                                // [TB][KP]
  float* us = kf + TB * KP;                                // [KMAX]
  float* bs = us + KMAX;                     // [TB] bonus r.(u*k) per step
  auto pidx = [](int i) { return (i / KQ) * (KQ + 4) + i % KQ; };

  const int cb = blockIdx.x % nvb;           // column block of the head
  const int bh = blockIdx.x / nvb;           // b * H + h
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x;
  const int jl = tid / KSPLIT, q = tid - jl * KSPLIT;
  const int c0 = cb * VB;
  const int lane = tid & 31, warp = tid >> 5;
  const int ncols = min(VB, V - c0);
  const int i0 = q * KQ;
  int j[COLS];
  bool own[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    j[c] = c0 + jl + c * HALF;
    own[c] = j[c] < V;
  }

  float s[COLS][KQ];
#pragma unroll
  for (int c = 0; c < COLS; ++c)
#pragma unroll
    for (int m = 0; m < KQ; ++m) {
      const int i = i0 + m;
      s[c][m] = (s0 != nullptr && own[c] && i < K)
                    ? s0[((long long)bh * K + i) * V + j[c]] : 0.0f;
    }
  for (int i = tid; i < KMAX; i += NT)
    us[i] = i < K ? u[(long long)h * K + i] : 0.0f;
  // Rows K..KMAX-1 of r, k and w stay zero (no copy writes them); rows
  // nt..TB-1 of a ragged last block are never read.
  const int pad = KMAX - K;
  for (int idx = tid; idx < TB * pad; idx += NT) {
    const int tt = idx / pad, i = K + idx - tt * pad;
    rraw[tt * KMAX + i] = Elt(0.0f);
    kraw[tt * KMAX + i] = Elt(0.0f);
    wbuf[tt * KP + pidx(i)] = 0.0f;
    wbuf[(TB + tt) * KP + pidx(i)] = 0.0f;
  }

  const long long row_b = (long long)b * Tlen * H + h;   // (b, t = 0, h)
  auto stage_rk = [&](int t0, int nt) {      // into the single r, k buffers
    const long long row = row_b + (long long)t0 * H;
    stage_rows<NT, Elt>(
        async_rows, nt, K,
        [&](int tt, int i) { return r + (row + (long long)tt * H) * K + i; },
        [&](int tt, int i) { return rraw + tt * KMAX + i; });
    stage_rows<NT, Elt>(
        async_rows, nt, K,
        [&](int tt, int i) { return k + (row + (long long)tt * H) * K + i; },
        [&](int tt, int i) { return kraw + tt * KMAX + i; });
  };
  auto stage_wv = [&](int t0, int nt, int sb) {   // into w, v buffer sb
    const long long row = row_b + (long long)t0 * H;
    stage_rows<NT, float>(
        async_rows, nt, K,
        [&](int tt, int i) { return w + (row + (long long)tt * H) * K + i; },
        [&](int tt, int i) { return wbuf + (sb * TB + tt) * KP + pidx(i); });
    stage_rows<NT, Elt>(
        async_rows, nt, ncols,
        [&](int tt, int i) {
          return v + (row + (long long)tt * H) * V + c0 + i;
        },
        [&](int tt, int i) { return vbuf + (sb * TB + tt) * VB + i; });
  };
  auto commit = [&] {
    if (async_rows) asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  const int nblocks = (Tlen + TB - 1) / TB;
  stage_rk(0, min(TB, Tlen));
  stage_wv(0, min(TB, Tlen), 0);
  commit();
  for (int n = 0; n < nblocks; ++n) {
    const int t0 = n * TB, nt = min(TB, Tlen - t0), cur = n & 1;
    const int t1 = t0 + TB, nt1 = min(TB, Tlen - t1);    // the next block
    if (async_rows) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();          // block n has landed; block n - 1 is consumed
    if (nt1 > 0) stage_wv(t1, nt1, cur ^ 1);
    // r and k to float32 (exact) in the steps' layout, and each step's
    // bonus r.(u*k): one warp a step, lanes over i, in one fixed order; a
    // warp takes PB steps at once so that their shuffle chains overlap
    for (int tb = warp * PB; tb < nt; tb += NWARPS * PB) {
      float p[PB];
#pragma unroll
      for (int e = 0; e < PB; ++e) {
        const int tt = tb + e;
        p[e] = 0.0f;
        if (tt < nt)
          for (int i = lane; i < KMAX; i += 32) {
            const float ri = to_f32(rraw[tt * KMAX + i]);
            const float ki = to_f32(kraw[tt * KMAX + i]);
            rf[tt * KP + pidx(i)] = ri;
            kf[tt * KP + pidx(i)] = ki;
            p[e] += ri * us[i] * ki;
          }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int e = 0; e < PB; ++e)
          p[e] += __shfl_xor_sync(0xffffffffu, p[e], off);
      if (lane == 0)
#pragma unroll
        for (int e = 0; e < PB; ++e)
          if (tb + e < nt) bs[tb + e] = p[e];
    }
    __syncthreads();          // the r, k copies of block n are consumed
    if (nt1 > 0) stage_rk(t1, nt1);
    commit();

    const float* wb = wbuf + cur * TB * KP;
    const Elt* vb = vbuf + cur * TB * VB;
    for (int tt = 0; tt < nt; ++tt) {
      float vj[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        vj[c] = own[c] ? to_f32(vb[tt * VB + jl + c * HALF]) : 0.0f;
      const float* rt = rf + tt * KP + pidx(i0);
      const float* kt = kf + tt * KP + pidx(i0);
      const float* wt = wb + tt * KP + pidx(i0);
      float a[COLS][4] = {};
#pragma unroll
      for (int m = 0; m < KQ; m += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(rt + m);
        const float4 k4 = *reinterpret_cast<const float4*>(kt + m);
        const float4 w4 = *reinterpret_cast<const float4*>(wt + m);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int c = 0; c < COLS; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            a[c][e] = fmaf(rr[e], s[c][m + e], a[c][e]);
            s[c][m + e] = fmaf(ww[e], s[c][m + e], kk[e] * vj[c]);
          }
      }
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        float dot = (a[c][0] + a[c][1]) + (a[c][2] + a[c][3]);
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        if (own[c] && q == 0)
          o[(row_b + (long long)(t0 + tt) * H) * V + j[c]] =
              dot + bs[tt] * vj[c];
      }
    }
  }

#pragma unroll
  for (int c = 0; c < COLS; ++c)
    if (own[c]) {
#pragma unroll
      for (int m = 0; m < KQ; ++m) {
        const int i = i0 + m;
        if (i < K) sT[((long long)bh * K + i) * V + j[c]] = s[c][m];
      }
    }
}

struct Plan {
  int kmax, vb, nvb, async_rows;
  long long ctas;
  int smem;
};

int kmax_for(int K) {
  return K <= 16 ? 16 : K <= 32 ? 32 : K <= 64 ? 64 : 128;
}

int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
  }();
  return n;
}

// The launch's shape: VB is the widest of 64, 32, 16 columns that does not
// leave half a CTA's columns idle for every head and gives at least 2 CTAs
// an SM; the rows go asynchronously when every row of r, k, w and v is a
// whole number of 16-byte chunks (the base pointers are checked at launch).
Plan make_plan(int dtype, long long bh, int K, int V) {
  const int elt = dtype == 1 ? 2 : 4;
  Plan p;
  p.kmax = kmax_for(K);
  p.vb = 4 * VB_MIN;
  while (p.vb > VB_MIN && (p.vb / 2 >= V ||
                      bh * ((V + p.vb - 1) / p.vb) < 2LL * sm_count()))
    p.vb /= 2;
  p.nvb = (V + p.vb - 1) / p.vb;
  p.ctas = bh * p.nvb;
  p.async_rows = (K * elt) % 16 == 0 && K % 4 == 0 && (V * elt) % 16 == 0;
  p.smem = smem_bytes(elt, p.kmax, p.vb);
  return p;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

template <typename Elt, int KMAX, int VB>
int launch(const Plan& p, const void* r, const void* k, const void* v,
           const float* w, const float* u, const float* s0, float* o,
           float* sT, int T, int H, int K, int V, cudaStream_t stream) {
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_kernel<Elt, KMAX, VB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int async_rows = p.async_rows && aligned16(r) && aligned16(k) &&
                         aligned16(v) && aligned16(w);
  wkv6_kernel<Elt, KMAX, VB><<<(unsigned)p.ctas, KSPLIT * VB / COLS,
                               p.smem, stream>>>(
      static_cast<const Elt*>(r), static_cast<const Elt*>(k),
      static_cast<const Elt*>(v), w, u, s0, o, sT, T, H, K, V, p.nvb,
      async_rows);
  return (int)cudaGetLastError();
}

template <typename Elt, int KMAX>
int by_vb(const Plan& p, const void* r, const void* k, const void* v,
          const float* w, const float* u, const float* s0, float* o,
          float* sT, int T, int H, int K, int V, cudaStream_t s) {
  if (p.vb == VB_MIN)
    return launch<Elt, KMAX, VB_MIN>(p, r, k, v, w, u, s0, o, sT, T, H, K, V,
                                     s);
  if (p.vb == 2 * VB_MIN)
    return launch<Elt, KMAX, 2 * VB_MIN>(p, r, k, v, w, u, s0, o, sT, T, H,
                                         K, V, s);
  return launch<Elt, KMAX, 4 * VB_MIN>(p, r, k, v, w, u, s0, o, sT, T, H, K,
                                       V, s);
}

template <typename Elt>
int dispatch(const Plan& p, const void* r, const void* k, const void* v,
             const float* w, const float* u, const float* s0, float* o,
             float* sT, int T, int H, int K, int V, cudaStream_t s) {
  switch (p.kmax) {
    case 16: return by_vb<Elt, 16>(p, r, k, v, w, u, s0, o, sT, T, H, K, V, s);
    case 32: return by_vb<Elt, 32>(p, r, k, v, w, u, s0, o, sT, T, H, K, V, s);
    case 64: return by_vb<Elt, 64>(p, r, k, v, w, u, s0, o, sT, T, H, K, V, s);
    default: return by_vb<Elt, 128>(p, r, k, v, w, u, s0, o, sT, T, H, K, V, s);
  }
}

bool valid(int dtype, int B, int T, int H, int K, int V) {
  return B > 0 && H > 0 && T > 0 && K > 0 && K <= 128 && V > 0 && V <= 256 &&
         (dtype == 0 || dtype == 1) &&
         (long long)B * H * ((V + VB_MIN - 1) / VB_MIN) <= 0x7fffffffLL;
}

}  // namespace

// K <= 128, V <= 256. dtype (of r, k, v) 0: float32, 1: bfloat16; w, u,
// s0 (may be null), o and sT are float32. Returns a cudaError_t.
extern "C" int wkv6_launch(int dtype, const void* r, const void* k,
                           const void* v, const float* w, const float* u,
                           const float* s0, float* o, float* sT, int B,
                           int T, int H, int K, int V, void* stream) {
  if (!valid(dtype, B, T, H, K, V)) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(dtype, (long long)B * H, K, V);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(p, r, k, v, w, u, s0, o, sT, T, H, K, V, s);
  return dispatch<__nv_bfloat16>(p, r, k, v, w, u, s0, o, sT, T, H, K, V, s);
}

// What wkv6_launch launches for these sizes: out[0] CTAs, out[1] threads
// per CTA, out[2] TB, out[3] VB, out[4] 1 when rows are staged by cp.async
// (0: plain loads; the launch also takes plain loads when a base pointer
// is not 16-byte aligned), out[5] dynamic shared bytes per CTA, out[6]
// KMAX, out[7] state columns per thread. Returns a cudaError_t.
extern "C" int wkv6_plan(int dtype, int B, int T, int H, int K, int V,
                         int* out) {
  if (!valid(dtype, B, T, H, K, V)) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(dtype, (long long)B * H, K, V);
  out[0] = (int)p.ctas;
  out[1] = KSPLIT * p.vb / COLS;
  out[2] = time_block(dtype == 1 ? 2 : 4, p.kmax);
  out[3] = p.vb;
  out[4] = p.async_rows;
  out[5] = p.smem;
  out[6] = p.kmax;
  out[7] = COLS;
  return 0;
}
