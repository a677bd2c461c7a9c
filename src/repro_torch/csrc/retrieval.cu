// Blocked top-M retrieval scans for Hopper: the dot-product proxy and the
// exact streamed NTN+FCN logit, both with a running top-M per query.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/retrieval.py:
// _blocked_topm (body _topm_kernel) and _blocked_topm_ntn (body
// _topm_ntn_kernel), which merge column blocks of the corpus one after the
// other into a running top-M held in the revisited output block.
//
// On this card the column blocks run in parallel instead, in two passes
// that share one selection and merge path:
//   1. block pass, one CTA per (corpus column block, 8 queries): the score
//      tile of the block (a dot per (query, row), or K dots of uq[k] with
//      the row plus dq[k], ReLU, the FCN stack and the pre-sigmoid logit)
//      goes to shared memory as (score, index) keys; a bitonic network sorts
//      each query's keys and the first min(M, block_cols) are written out;
//   2. merge pass, one thread per kept key: its rank in the union of the
//      per-block lists is its own position plus a binary search in every
//      other list; keys of rank < M land at that rank.
// Keys are ordered by (-score, ascending corpus index), the order the TPU
// kernel's `top_k` merge produces; indices are unique, so ranks are too.
// Non-finite scores become NEG_FILL = -3e38 (NaN rows rank last among real
// rows); pad columns are -inf and never surface, because every block keeps
// all its real rows up to M and M <= N. Only the per-block lists
// ([Q, blocks, min(M, block_cols)] keys) reach global memory, never the
// [Q, N] score matrix.
//
// What bounds it on this card: the dot scan is launch- and latency-bound
// (F = 32 MACs per (query, row)); the NTN scan is bound by the float32 FMA
// rate (about 680 MACs per (query, row) at F = 32, K = 16, FCN 16-8-4-1).
// Each thread keeps its corpus row in registers and reuses it for the 8
// queries of its CTA; the query operands and the FCN activations live in
// shared memory.
#include "simgnn_common.cuh"

#include <limits.h>
#include <math.h>

#define TOPM_BQ 8             // queries per CTA in the block pass
#define TOPM_FMAX 64          // widest embedding the scans take
#define TOPM_MAX_COLS 1024    // RETRIEVAL_MAX_BLOCK_COLS
#define TOPM_NEG_FILL (-3.0e38f)

__device__ __forceinline__ bool topm_before(float sa, int ia, float sb,
                                            int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

__device__ __forceinline__ float topm_fill(float s) {
  return isfinite(s) ? s : TOPM_NEG_FILL;
}

static int topm_pow2(int cols) {
  int p = 1;
  while (p < cols) p <<= 1;
  return p;
}

// Loads corpus row `col` (F floats) into registers; the unrolled, guarded
// loop keeps `row` out of local memory.
__device__ __forceinline__ void topm_load_row(const float* __restrict__ corpus,
                                              long long col, int F,
                                              float (&row)[TOPM_FMAX]) {
#pragma unroll
  for (int f = 0; f < TOPM_FMAX; ++f)
    row[f] = f < F ? __ldg(corpus + col * F + f) : 0.0f;
}

__device__ __forceinline__ float topm_dot(const float* q,
                                          const float (&row)[TOPM_FMAX],
                                          int F) {
  float acc = 0.0f;
#pragma unroll
  for (int f = 0; f < TOPM_FMAX; ++f)
    if (f < F) acc = fmaf(q[f], row[f], acc);
  return acc;
}

// Sorts each of the TOPM_BQ segments of p2 keys into before-order with one
// bitonic network run over all segments at once.
__device__ void topm_sort_segments(float* ks, int* ki, int p2) {
  const int total = TOPM_BQ * p2;
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int x = threadIdx.x; x < total; x += blockDim.x) {
        const int y = x ^ j;
        if (y <= x) continue;
        const bool up = ((x & (p2 - 1)) & k) == 0;
        const bool swap = up ? topm_before(ks[y], ki[y], ks[x], ki[x])
                             : topm_before(ks[x], ki[x], ks[y], ki[y]);
        if (swap) {
          const float ts = ks[x];
          ks[x] = ks[y];
          ks[y] = ts;
          const int ti = ki[x];
          ki[x] = ki[y];
          ki[y] = ti;
        }
      }
      __syncthreads();
    }
  }
}

// Writes the first m1 sorted keys of each live query of the CTA to the
// per-block lists [Q, nblk, m1].
__device__ void topm_write_lists(const float* ks, const int* ki, int p2,
                                 int q0, int Q, int nblk, int m1,
                                 float* __restrict__ ps, int* __restrict__ pi) {
  const int blk = blockIdx.x;
  for (int x = threadIdx.x; x < TOPM_BQ * m1; x += blockDim.x) {
    const int q = x / m1, r = x - q * m1;
    if (q0 + q >= Q) continue;
    const size_t o = ((size_t)(q0 + q) * nblk + blk) * m1 + r;
    ps[o] = ks[q * p2 + r];
    pi[o] = ki[q * p2 + r];
  }
}

// Stores a score tile entry: real rows get their (filled) score, pad
// columns -inf with their own column number, the pow2 tail -inf/INT_MAX.
__device__ __forceinline__ void topm_store(float* ks, int* ki, int q, int p2,
                                           int c, int cols, long long col,
                                           bool real, float s) {
  ks[q * p2 + c] = real ? topm_fill(s) : -INFINITY;
  ki[q * p2 + c] = c < cols ? (int)col : INT_MAX;
}

__global__ void __launch_bounds__(SIMGNN_THREADS)
topm_dot_block_kernel(const float* __restrict__ qv,
                      const float* __restrict__ corpus, int Q, int N, int F,
                      int cols, int p2, int m1, int nblk,
                      float* __restrict__ ps, int* __restrict__ pi) {
  extern __shared__ float smem[];
  float* ks = smem;                                   // [BQ, p2]
  int* ki = (int*)(ks + TOPM_BQ * p2);                // [BQ, p2]
  float* qs = (float*)(ki + TOPM_BQ * p2);            // [BQ, F]
  const int q0 = blockIdx.y * TOPM_BQ;
  for (int x = threadIdx.x; x < TOPM_BQ * F; x += blockDim.x) {
    const int q = x / F;
    qs[x] = q0 + q < Q ? qv[(size_t)q0 * F + x] : 0.0f;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < p2; c += blockDim.x) {
    const long long col = (long long)blockIdx.x * cols + c;
    const bool real = c < cols && col < N;
    float row[TOPM_FMAX];
    topm_load_row(corpus, real ? col : 0, F, row);
    for (int q = 0; q < TOPM_BQ; ++q)
      topm_store(ks, ki, q, p2, c, cols, col, real,
                 real ? topm_dot(qs + q * F, row, F) : 0.0f);
  }
  __syncthreads();
  topm_sort_segments(ks, ki, p2);
  topm_write_lists(ks, ki, p2, q0, Q, nblk, m1, ps, pi);
}

__global__ void __launch_bounds__(SIMGNN_THREADS)
topm_ntn_block_kernel(const float* __restrict__ uq,
                      const float* __restrict__ dq,
                      const float* __restrict__ corpus, int Q, int N, int F,
                      int K, int hmax, int cols, int p2, int m1, int nblk,
                      float* __restrict__ ps, int* __restrict__ pi,
                      SimgnnParams P) {
  extern __shared__ float smem[];
  float* ks = smem;                                   // [BQ, p2]
  int* ki = (int*)(ks + TOPM_BQ * p2);                // [BQ, p2]
  float* us = (float*)(ki + TOPM_BQ * p2);            // [BQ, K, F]
  float* ds = us + TOPM_BQ * K * F;                   // [BQ, K]
  float* act = ds + TOPM_BQ * K;                      // [2, hmax, threads]
  const int T = blockDim.x, t = threadIdx.x;
  const int q0 = blockIdx.y * TOPM_BQ;
  for (int x = t; x < TOPM_BQ * K * F; x += T)
    us[x] = q0 + x / (K * F) < Q ? uq[(size_t)q0 * K * F + x] : 0.0f;
  for (int x = t; x < TOPM_BQ * K; x += T)
    ds[x] = q0 + x / K < Q ? dq[(size_t)q0 * K + x] : 0.0f;
  __syncthreads();
  for (int c = t; c < p2; c += T) {
    const long long col = (long long)blockIdx.x * cols + c;
    const bool real = c < cols && col < N;
    float row[TOPM_FMAX];
    topm_load_row(corpus, real ? col : 0, F, row);
    for (int q = 0; q < TOPM_BQ; ++q) {
      float logit = 0.0f;
      if (real) {
        // NTN activations, query side pre-collapsed: relu(uq[k].row + dq[k]).
        float* cur = act;
        float* nxt = act + hmax * T;
        for (int k = 0; k < K; ++k) {
          const float a = topm_dot(us + (q * K + k) * F, row, F);
          cur[k * T + t] = simgnn_relu(a + ds[q * K + k]);
        }
        // The FCN stack; the pre-sigmoid logit is the score.
        for (int l = 0; l < P.n_fcn; ++l) {
          const int din = P.fcn_dims[l], dout = P.fcn_dims[l + 1];
          const float* w = P.fcn_w[l];
          for (int o = 0; o < dout; ++o) {
            float acc = 0.0f;
            for (int i = 0; i < din; ++i)
              acc = fmaf(cur[i * T + t], __ldg(w + i * dout + o), acc);
            acc += __ldg(P.fcn_b[l] + o);
            nxt[o * T + t] = l + 1 < P.n_fcn ? simgnn_relu(acc) : acc;
          }
          float* tmp = cur;
          cur = nxt;
          nxt = tmp;
        }
        logit = cur[t];
      }
      topm_store(ks, ki, q, p2, c, cols, col, real, logit);
    }
  }
  __syncthreads();
  topm_sort_segments(ks, ki, p2);
  topm_write_lists(ks, ki, p2, q0, Q, nblk, m1, ps, pi);
}

// Merge pass: grid (Q, ceil(nblk * m1 / threads)); one thread per kept key.
__global__ void __launch_bounds__(SIMGNN_THREADS)
topm_merge_kernel(const float* __restrict__ ps, const int* __restrict__ pi,
                  int nblk, int m1, int M, float* __restrict__ out_s,
                  int* __restrict__ out_i) {
  const long long q = blockIdx.x;
  const int e = blockIdx.y * blockDim.x + threadIdx.x;
  const int total = nblk * m1;
  if (e >= total) return;
  const float* s = ps + q * total;
  const int* id = pi + q * total;
  const int b = e / m1;
  const float se = s[e];
  const int ie = id[e];
  int rank = e - b * m1;
  for (int o = 0; o < nblk && rank < M; ++o) {
    if (o == b) continue;
    const float* so = s + (size_t)o * m1;
    const int* io = id + (size_t)o * m1;
    int lo = 0, hi = m1;                  // keys of list o before this one
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (topm_before(so[mid], io[mid], se, ie)) lo = mid + 1;
      else hi = mid;
    }
    rank += lo;
  }
  if (rank < M) {
    out_s[q * M + rank] = se;
    out_i[q * M + rank] = ie;
  }
}

static int topm_nblk(int N, int cols) { return (N + cols - 1) / cols; }

// Entries of the per-block lists a scan needs (Q * blocks * min(M, cols)).
extern "C" long long topm_list_entries(int Q, int N, int cols, int M) {
  return (long long)Q * topm_nblk(N, cols) * (M < cols ? M : cols);
}

static cudaError_t topm_merge(const float* ps, const int* pi, int Q, int nblk,
                              int m1, int M, float* out_s, int* out_i,
                              cudaStream_t stream) {
  const int total = nblk * m1;
  const dim3 grid(Q, (total + SIMGNN_THREADS - 1) / SIMGNN_THREADS);
  topm_merge_kernel<<<grid, SIMGNN_THREADS, 0, stream>>>(ps, pi, nblk, m1, M,
                                                         out_s, out_i);
  return cudaGetLastError();
}

// Shapes the two passes' grids take: ceil(Q / 8) and the merge pass's
// ceil(blocks * min(M, cols) / threads) must fit a grid's y extent.
static bool topm_shapes_ok(int Q, int N, int F, int cols, int M) {
  if (Q <= 0 || N <= 0 || F <= 0 || F > TOPM_FMAX || cols <= 0 ||
      cols > TOPM_MAX_COLS || M <= 0 || M > N)
    return false;
  const long long total = (long long)topm_nblk(N, cols) * (M < cols ? M : cols);
  return (Q + TOPM_BQ - 1) / TOPM_BQ <= 65535 &&
         (total + SIMGNN_THREADS - 1) / SIMGNN_THREADS <= 65535;
}

extern "C" int topm_dot_launch(const float* qv, const float* corpus, int Q,
                               int N, int F, int cols, int M, float* ps,
                               int* pi, float* out_s, int* out_i,
                               void* stream) {
  if (!topm_shapes_ok(Q, N, F, cols, M)) return (int)cudaErrorInvalidValue;
  const int p2 = topm_pow2(cols), nblk = topm_nblk(N, cols);
  const int m1 = M < cols ? M : cols;
  const size_t smem = (2 * (size_t)TOPM_BQ * p2 + (size_t)TOPM_BQ * F) * 4;
  cudaError_t err = simgnn_set_smem(topm_dot_block_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nblk, (Q + TOPM_BQ - 1) / TOPM_BQ);
  topm_dot_block_kernel<<<grid, SIMGNN_THREADS, smem, (cudaStream_t)stream>>>(
      qv, corpus, Q, N, F, cols, p2, m1, nblk, ps, pi);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)topm_merge(ps, pi, Q, nblk, m1, M, out_s, out_i,
                         (cudaStream_t)stream);
}

extern "C" int topm_ntn_launch(const float* uq, const float* dq,
                               const float* corpus, int Q, int N, int F, int K,
                               int cols, int M, float* ps, int* pi,
                               float* out_s, int* out_i, const SimgnnParams* P,
                               void* stream) {
  if (!topm_shapes_ok(Q, N, F, cols, M) || K < 1 || P->n_fcn < 1 ||
      P->fcn_dims[0] != K || P->fcn_dims[P->n_fcn] != 1)
    return (int)cudaErrorInvalidValue;
  int hmax = 0;
  for (int l = 0; l <= P->n_fcn; ++l)
    hmax = P->fcn_dims[l] > hmax ? P->fcn_dims[l] : hmax;
  const int p2 = topm_pow2(cols), nblk = topm_nblk(N, cols);
  const int m1 = M < cols ? M : cols;
  const size_t smem = (2 * (size_t)TOPM_BQ * p2 + (size_t)TOPM_BQ * K * F +
                       (size_t)TOPM_BQ * K +
                       2 * (size_t)hmax * SIMGNN_THREADS) * 4;
  cudaError_t err = simgnn_set_smem(topm_ntn_block_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nblk, (Q + TOPM_BQ - 1) / TOPM_BQ);
  topm_ntn_block_kernel<<<grid, SIMGNN_THREADS, smem, (cudaStream_t)stream>>>(
      uq, dq, corpus, Q, N, F, K, hmax, cols, p2, m1, nblk, ps, pi, *P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)topm_merge(ps, pi, Q, nblk, m1, M, out_s, out_i,
                         (cudaStream_t)stream);
}
