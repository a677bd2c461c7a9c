// Blocked top-M retrieval scans for Hopper: the dot-product proxy and the
// exact streamed NTN+FCN logit, both with a running top-M per query.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/retrieval.py:
// _blocked_topm (body _topm_kernel) and _blocked_topm_ntn (body
// _topm_ntn_kernel), which merge column blocks of the corpus one after the
// other into a running top-M held in the revisited output block.
//
// Keys are ordered by (-score, ascending corpus index), the order the TPU
// kernel's `top_k` merge produces; indices are unique, so the order is
// total and any exact selection gives the same keys in the same order.
// Non-finite scores become NEG_FILL = -3e38 (NaN rows rank last among real
// rows); pads and empty slots never surface, because M <= N. A score is
// the float32 chain acc = fmaf(q[f], row[f], acc) over f = 0..F-1 from 0,
// on every route.
//
// Two routes (kernels/retrieval.py `topm_plan` and `topm_ntn_plan` pick one a
// launch):
//
//   * the select route (M <= TOPM_MAX_SELECT): one launch, nothing in global
//     memory but the result. A cluster of cs CTAs (cs <= 8) serves a group
//     of qb <= TOPM_QB queries, each CTA a range of corpus chunks,
//     double-buffered in shared memory: at F = 32 TMA boxes of up to 256
//     rows (128-byte swizzle), else cp.async into rows padded to 4 mod 32
//     floats. A scoring phase writes the chunk's filled scores into a
//     shared score tile: the dot phase (four rows a thread against its
//     query, held in registers) or the NTN phase (a lane's one or two
//     staged rows in registers against a query's uq slices, read from
//     shared memory as warp-wide broadcasts, the FCN stack in registers).
//     Selection follows the WarpSelect scheme of Johnson, Douze and Jegou
//     ("Billion-scale similarity search with GPUs", 2017): a warp owns one
//     query's sorted top-32R in registers (R keys a lane) and a queue in
//     shared memory; a key enters the queue only if it comes before a bound
//     on the query's M-th key, and 32 queued keys are sorted by rank and
//     merged in by a bitonic merge over shuffles; the W = 8 / qb warps of
//     a query take its rows in turn. The bound is the list's own M-th key
//     or, once a chunk, the worst of the keys the cluster's W cs warps of
//     the query publish in shared memory (each its key ceil(M / W cs) - 1,
//     so the worst has M keys at or before it). The CTA's W warps of a
//     query merge pairwise, each CTA pushes its lists into rank 0's shared
//     memory through distributed shared memory, and rank 0 merges them
//     and writes [Q, M].
//   * the sort route (M above TOPM_MAX_SELECT, layouts the select route
//     cannot hold, NTN heads wider than its phase holds): two passes. One
//     CTA per (corpus column block, 8 queries) stores the block's keys in
//     shared memory, sorts each query's keys with a bitonic network and
//     writes the first min(M, block_cols) to per-block lists [Q, blocks,
//     min(M, block_cols)]; a merge pass ranks each kept key by binary
//     searches in the other lists.
//
// What bounds it on this card: the dot scan does F = 32 MACs per (query,
// row), under a microsecond of FMA issue at the served shape; what costs
// is selection and, across the card, reading the corpus from L2 once per
// query group. The select route spends about one compare a row once a
// bound is tight, no block barrier on a queue merge, and stages the next
// chunk while the current one is scored. The NTN scan is bound by the
// float32 FMA rate (about 680 MACs per (query, row) at F = 32, K = 16, FCN
// 16-8-4-1): its phase keeps every operand of the chains in registers or
// in shared-memory broadcasts (one 16-byte load feeds eight FMAs at two
// rows a lane), and its plan sizes the grid so that the busiest SM holds
// close to 1/132 of the work (at the served shape one query a CTA, a
// cluster of 2 CTAs a query, one CTA an SM).
#include "async_copy.cuh"
#include "simgnn_common.cuh"

#include <cooperative_groups.h>
#include <cuda.h>
#include <limits.h>
#include <math.h>
#include <string.h>

namespace cg = cooperative_groups;

#define TOPM_BQ 8             // queries per CTA in the block pass
#define TOPM_FMAX 64          // widest embedding the scans take
#define TOPM_MAX_COLS 1024    // RETRIEVAL_MAX_BLOCK_COLS
#define TOPM_NEG_FILL (-3.0e38f)

#define TOPM_SEL_THREADS 256  // threads a CTA on the select route
#define TOPM_QB 4             // most queries a CTA (8 / qb warps each)
#define TOPM_MAX_CS 8         // CTAs a cluster (the portable limit)
#define TOPM_MAX_SELECT 256   // widest M the select route keeps (8 a lane)
#define TOPM_QUEUE 64         // queue slots a warp
#define TOPM_MAX_CHUNK 256    // rows the dot phase stages at once (4 a thread)
#define TOPM_NTN_MAX_CHUNK 512  // rows the NTN phase stages at once
#define TOPM_BOX 256          // rows of a TMA box (the tensor map's limit)
#define TOPM_NTN_HIDDEN 16    // widest FCN layer after K the NTN phase holds

// Stage clocks, compiled in only by tools/topm_stages.py (which defines
// TOPM_STAGES): thread 0 of each CTA sums clock64() cycles by stage into
// TOPM_STAGE_SLOTS slots a CTA of the buffer the tool hands
// topm_stage_buffers (slots 9 and 10: thread 0's cycles in queue drains
// and their number; 14: the SM; 15: the global timer at the start; 16-19:
// thread 0's cycles in the NTN phase's slices and first FCN layer, and in
// the later FCN layers, each with its count); the merge pass records each
// CTA's first and last clock64() in two slots. The stage build adds a
// barrier after each chunk's selection, so that its cycles are not booked
// to the next chunk's wait.
#define TOPM_STAGE_SLOTS 20
#ifdef TOPM_STAGES
__device__ long long* topm_scan_stage_buf;
__device__ long long* topm_merge_stage_buf;
__device__ volatile int topm_stage_sink;
extern "C" int topm_stage_buffers(long long* scan, long long* merge) {
  cudaError_t err = cudaMemcpyToSymbol(topm_scan_stage_buf, &scan,
                                       sizeof(scan));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(topm_merge_stage_buf, &merge, sizeof(merge));
}
#define TOPM_CLOCK_START()                                               \
  long long topm_t = clock64(), topm_d[TOPM_STAGE_SLOTS] = {};           \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(topm_d[15]))
#define TOPM_LAP(k)                                                      \
  do {                                                                   \
    if (threadIdx.x == 0) {                                              \
      const long long now = clock64();                                   \
      topm_d[k] += now - topm_t;                                         \
      topm_t = now;                                                      \
    }                                                                    \
  } while (0)
#define TOPM_CLOCK_END(cta)                                              \
  do {                                                                   \
    if (threadIdx.x == 0) {                                              \
      unsigned sm;                                                       \
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));                    \
      long long* b = topm_scan_stage_buf + (long long)(cta)*TOPM_STAGE_SLOTS; \
      for (int k = 0; k < TOPM_STAGE_SLOTS; ++k) b[k] = topm_d[k];       \
      b[14] = sm;                                                        \
    }                                                                    \
  } while (0)
#define TOPM_STAGE_SYNC() __syncthreads()
// the stage sums, handed to a scoring phase
#define TOPM_STAGE_PARAM , long long* topm_d
#define TOPM_STAGE_ARG , topm_d
#else
#define TOPM_CLOCK_START() \
  do {                     \
  } while (0)
#define TOPM_LAP(k) \
  do {              \
  } while (0)
#define TOPM_CLOCK_END(cta) \
  do {                      \
  } while (0)
#define TOPM_STAGE_SYNC() \
  do {                    \
  } while (0)
#define TOPM_STAGE_PARAM
#define TOPM_STAGE_ARG
#endif

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

// ------------------------------------------------------- the sort route

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

// Stage build only: thread 0 waits for its row's loads (a store that
// depends on every element) and books the wait to stage `k`.
#ifdef TOPM_STAGES
#define TOPM_ROW_READY(row, F, k)                                        \
  do {                                                                   \
    if (threadIdx.x == 0) {                                              \
      int x = 0;                                                         \
      for (int f = 0; f < TOPM_FMAX; ++f)                                \
        if (f < (F)) x ^= __float_as_int((row)[f]);                      \
      topm_stage_sink = x;                                               \
    }                                                                    \
    TOPM_LAP(k);                                                         \
  } while (0)
#else
#define TOPM_ROW_READY(row, F, k) \
  do {                            \
  } while (0)
#endif

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
  TOPM_CLOCK_START();
  float* ks = smem;                                   // [BQ, p2]
  int* ki = (int*)(ks + TOPM_BQ * p2);                // [BQ, p2]
  float* qs = (float*)(ki + TOPM_BQ * p2);            // [BQ, F]
  const int q0 = blockIdx.y * TOPM_BQ;
  for (int x = threadIdx.x; x < TOPM_BQ * F; x += blockDim.x) {
    const int q = x / F;
    qs[x] = q0 + q < Q ? qv[(size_t)q0 * F + x] : 0.0f;
  }
  __syncthreads();
  TOPM_LAP(0);
  for (int c = threadIdx.x; c < p2; c += blockDim.x) {
    const long long col = (long long)blockIdx.x * cols + c;
    const bool real = c < cols && col < N;
    float row[TOPM_FMAX];
    topm_load_row(corpus, real ? col : 0, F, row);
    TOPM_ROW_READY(row, F, 1);
    for (int q = 0; q < TOPM_BQ; ++q) {
      const float s = real ? topm_dot(qs + q * F, row, F) : 0.0f;
      TOPM_LAP(2);
      topm_store(ks, ki, q, p2, c, cols, col, real, s);
      TOPM_LAP(3);
    }
  }
  __syncthreads();
  TOPM_LAP(4);
  topm_sort_segments(ks, ki, p2);
  TOPM_LAP(5);
  topm_write_lists(ks, ki, p2, q0, Q, nblk, m1, ps, pi);
  TOPM_LAP(6);
  TOPM_CLOCK_END(blockIdx.y * gridDim.x + blockIdx.x);
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

// Stage build only: each thread of a merge CTA raises the CTA's last-clock
// slot as it leaves.
#ifdef TOPM_STAGES
#define TOPM_MERGE_START()                                               \
  do {                                                                   \
    if (threadIdx.x == 0)                                                \
      topm_merge_stage_buf[2 * (blockIdx.y * gridDim.x + blockIdx.x)] =  \
          clock64();                                                     \
  } while (0)
#define TOPM_MERGE_END()                                                 \
  atomicMax((unsigned long long*)topm_merge_stage_buf +                  \
                2 * (blockIdx.y * gridDim.x + blockIdx.x) + 1,           \
            (unsigned long long)clock64())
#else
#define TOPM_MERGE_START() \
  do {                     \
  } while (0)
#define TOPM_MERGE_END() \
  do {                   \
  } while (0)
#endif

// Merge pass: grid (Q, ceil(nblk * m1 / threads)); one thread per kept key.
__global__ void __launch_bounds__(SIMGNN_THREADS)
topm_merge_kernel(const float* __restrict__ ps, const int* __restrict__ pi,
                  int nblk, int m1, int M, float* __restrict__ out_s,
                  int* __restrict__ out_i) {
  TOPM_MERGE_START();
  const long long q = blockIdx.x;
  const int e = blockIdx.y * blockDim.x + threadIdx.x;
  const int total = nblk * m1;
  if (e >= total) {
    TOPM_MERGE_END();
    return;
  }
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
  TOPM_MERGE_END();
}

// ----------------------------------------------- warp-level top-M selection
//
// Shared by any scan that produces one (score, index) key a lane at a time:
// WarpTopM<R> holds a query's best 32R keys, sorted, key j * 32 + lane in
// lane `lane`'s key[j]; `t` is key m - 1, which a new key must come before
// to matter. All lanes of the warp call every member together.

struct TopmKey {
  float s;
  int i;
};

__device__ __forceinline__ TopmKey topm_sentinel() {
  return TopmKey{-INFINITY, INT_MAX};
}

__device__ __forceinline__ bool key_before(const TopmKey& a,
                                           const TopmKey& b) {
  return topm_before(a.s, a.i, b.s, b.i);
}

__device__ __forceinline__ TopmKey key_shfl(const TopmKey& k, int src) {
  return TopmKey{__shfl_sync(0xffffffffu, k.s, src),
                 __shfl_sync(0xffffffffu, k.i, src)};
}

// One compare-exchange of a network across lanes at distance d: the lane
// keeps the better of its key and its partner's when keep_best, else the
// worse.
__device__ __forceinline__ TopmKey key_exchange(const TopmKey& k, int d,
                                                bool keep_best) {
  const TopmKey o{__shfl_xor_sync(0xffffffffu, k.s, d),
                  __shfl_xor_sync(0xffffffffu, k.i, d)};
  const bool take = keep_best ? key_before(o, k) : key_before(k, o);
  return take ? o : k;
}

template <int R>
struct WarpTopM {
  TopmKey key[R];
  TopmKey t;
  int m1;                   // m - 1

  __device__ __forceinline__ void init(int m) {
#pragma unroll
    for (int j = 0; j < R; ++j) key[j] = topm_sentinel();
    m1 = m - 1;
    t = topm_sentinel();
  }

  // Sorts a bitonic list (a bitonic merge: log2(32R) half-cleaners, the
  // first log2(R) inside each lane) and reads the new threshold.
  __device__ __forceinline__ void clean(int lane) {
#pragma unroll
    for (int d = R / 2; d > 0; d >>= 1)
#pragma unroll
      for (int j = 0; j < R; ++j)
        if ((j & d) == 0) {
          const TopmKey a = key[j], b = key[j + d];
          const bool sw = key_before(b, a);
          key[j] = sw ? b : a;
          key[j + d] = sw ? a : b;
        }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
#pragma unroll
      for (int j = 0; j < R; ++j)
        key[j] = key_exchange(key[j], d, (lane & d) == 0);
    t = at(m1);
  }

  // Merges in a sorted batch of 32 keys, one a lane: the better of each
  // key and its mirror in the batch (padded to 32R with sentinels) is a
  // bitonic list that holds the best 32R of both; only the last register
  // meets a batch key.
  __device__ __forceinline__ void insert32(const TopmKey& b, int lane) {
    const TopmKey r = key_shfl(b, 31 - lane);
    if (key_before(r, key[R - 1])) key[R - 1] = r;
    clean(lane);
  }

  // Merges in a sorted list of 32R keys held in shared memory or a peer
  // CTA's distributed shared memory, the same way.
  __device__ __forceinline__ void merge(const float* s, const int* i,
                                        int lane) {
    TopmKey r[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int p = (R - 1 - j) * 32 + 31 - lane;   // 32R - 1 - (32j + lane)
      r[j] = TopmKey{s[p], i[p]};
    }
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (key_before(r[j], key[j])) key[j] = r[j];
    clean(lane);
  }

  // Key `pos` of the list (register pos / 32 of lane pos % 32), to all
  // lanes.
  __device__ __forceinline__ TopmKey at(int pos) const {
    TopmKey v = key[0];
#pragma unroll
    for (int j = 1; j < R; ++j)
      if (j == pos >> 5) v = key[j];
    return key_shfl(v, pos & 31);
  }

  __device__ __forceinline__ void load(const float* s, const int* i,
                                       int lane) {
#pragma unroll
    for (int j = 0; j < R; ++j) key[j] = TopmKey{s[j * 32 + lane],
                                                 i[j * 32 + lane]};
  }

  __device__ __forceinline__ void store(float* s, int* i, int lane) const {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      s[j * 32 + lane] = key[j].s;
      i[j * 32 + lane] = key[j].i;
    }
  }

  // The first m keys to [m] outputs.
  __device__ __forceinline__ void write(float* __restrict__ s,
                                        int* __restrict__ i, int m,
                                        int lane) const {
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (j * 32 + lane < m) {
        s[j * 32 + lane] = key[j].s;
        i[j * 32 + lane] = key[j].i;
      }
  }
};

// A warp's queue: TOPM_QUEUE (score, index) pairs in shared memory.
__device__ __forceinline__ TopmKey queue_key(const float2* q, int at) {
  const float2 v = q[at];
  return TopmKey{v.x, __float_as_int(v.y)};
}

__device__ __forceinline__ void queue_put(float2* q, int at,
                                          const TopmKey& k) {
  q[at] = make_float2(k.s, __int_as_float(k.i));
}

// Merges the first min(cnt, 32) queued keys into the list and moves the
// rest to the front of the queue. The batch is sorted by rank (each lane
// counts the queued keys before its own; indices are unique, so ranks
// are too) and merged in by insert32. Returns the new fill.
template <int R>
__device__ __forceinline__ int topm_drain(WarpTopM<R>& sel, float2* q,
                                          int cnt, int lane) {
  const int take = cnt < 32 ? cnt : 32;
  TopmKey b = lane < take ? queue_key(q, lane) : topm_sentinel();
  int rank = 0;
#pragma unroll 8
  for (int j = 0; j < take; ++j) rank += key_before(queue_key(q, j), b);
  const bool more = lane + 32 < cnt;
  TopmKey x;
  if (more) x = queue_key(q, lane + 32);
  __syncwarp();
  if (lane < take) queue_put(q, 32 + rank, b);
  __syncwarp();
  b = lane < take ? queue_key(q, 32 + lane) : topm_sentinel();
  __syncwarp();
  if (more) queue_put(q, lane, x);
  __syncwarp();
  sel.insert32(b, lane);
  return cnt > 32 ? cnt - 32 : 0;
}

// Offers one key a lane to a warp's queue: a key enters only if it comes
// before `ft`, a threshold the query's final M-th key cannot be worse than
// (the list's own M-th key, or one another warp published). Returns the
// new fill; the caller drains at 32.
__device__ __forceinline__ int topm_offer(float2* q, int cnt, bool real,
                                          const TopmKey& k,
                                          const TopmKey& ft, int lane) {
  const bool pass = real && key_before(k, ft);
  const unsigned ball = __ballot_sync(0xffffffffu, pass);
  if (pass) queue_put(q, cnt + __popc(ball & ((1u << lane) - 1u)), k);
  return cnt + __popc(ball);
}

// A key as one 64-bit word (score bits high, index low), so that a
// threshold is published and read in one access.
__device__ __forceinline__ unsigned long long key_pack(const TopmKey& k) {
  return ((unsigned long long)__float_as_uint(k.s) << 32) | (unsigned)k.i;
}

__device__ __forceinline__ TopmKey key_unpack(unsigned long long v) {
  return TopmKey{__uint_as_float((unsigned)(v >> 32)), (int)(unsigned)v};
}

// Before every key a scan stores (their scores are finite).
__device__ __forceinline__ TopmKey topm_first() {
  return TopmKey{INFINITY, INT_MIN};
}

// The worst of the warp's keys (lowest score, then highest index), by two
// warp reductions: scores as unsigned integers in score order (-0 read as
// +0, which it equals), then the indices of the lanes that hold the
// lowest.
__device__ __forceinline__ TopmKey warp_worst(const TopmKey& k) {
  const unsigned b = __float_as_uint(k.s == 0.0f ? 0.0f : k.s);
  const unsigned u = b & 0x80000000u ? ~b : b | 0x80000000u;
  const unsigned lo = __reduce_min_sync(0xffffffffu, u);
  const unsigned hi = __reduce_max_sync(
      0xffffffffu, u == lo ? (unsigned)k.i ^ 0x80000000u : 0u);
  return TopmKey{__uint_as_float(lo & 0x80000000u ? lo & 0x7fffffffu : ~lo),
                 (int)(hi ^ 0x80000000u)};
}

// mbarrier and bulk-copy (TMA) helpers of the select route's staging.
__device__ __forceinline__ unsigned topm_smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(topm_smem(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   topm_smem(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(topm_smem(bar)),
      "r"(parity)
      : "memory");
}

// One box of a 2-D tensor map (rows y.. of the corpus, all 32 columns)
// into shared memory by TMA, counted on `bar`.
__device__ __forceinline__ void tma_load_rows(float* dst,
                                              const CUtensorMap* map, int y,
                                              unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(topm_smem(dst)),
      "l"(map), "r"(0), "r"(y), "r"(topm_smem(bar))
      : "memory");
}

// ------------------------------------------------------- the select route

// Shared layout and partition of a select-route launch, fixed by
// kernels/retrieval.py `topm_plan` / `topm_ntn_plan` (offsets in 4-byte
// words).
struct TopmLayout {
  int chunk;          // corpus rows staged at once
  int ld;             // staged row stride (floats), 4 mod 32
  int lds;            // score tile row stride, 8 mod 32
  int cs;             // CTAs a cluster
  int per;            // chunks a CTA walks
  int r;              // keys a lane (list of 32r)
  int qb;             // queries a CTA (1, 2 or TOPM_QB; the dot scan: 4)
  int stage_off[2];   // [chunk, ld] corpus rows, two buffers
  int sc_off;         // [TOPM_QB, lds] scores of the staged chunk
  int queue_off;      // [warps][TOPM_QUEUE] queued (score, index) pairs
  int thr_off;        // [warps] published bounds, 64-bit each
  int bar_off;        // [2] mbarriers of the staged chunks, 64-bit each
  int list_off;       // [2][TOPM_QB][32r] half 1's list to half 0
  int gather_off;     // [2][cs][TOPM_QB][32r] the cluster's lists (rank 0)
  int ntn_off;        // the NTN operands (topm_ntn_words; none for dot)
  int smem_words;
};

__host__ __device__ __forceinline__ int topm_ru4(int x) {
  return (x + 3) & ~3;
}

extern "C" int topm_layout_size(void) { return (int)sizeof(TopmLayout); }

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Stages chunk rows [r0, r0 + n) of the corpus into `dst` (row stride ld)
// by cp.async: 16-byte copies when `vec` (F % 4 == 0 and the corpus 16-byte
// aligned), else 4-byte ones; consecutive threads take consecutive pieces.
__device__ __forceinline__ void topm_stage_chunk(float* dst,
                                                 const float* __restrict__ src,
                                                 int n, int F, int ld,
                                                 bool vec) {
  if (vec) {
    const int fq = F >> 2, pieces = n * fq;
    for (int p = threadIdx.x; p < pieces; p += TOPM_SEL_THREADS) {
      const int r = p / fq, k = p - r * fq;
      cp_async16(dst + r * ld + 4 * k, src + 4 * (size_t)p);
    }
  } else {
    const int total = n * F;
    for (int e = threadIdx.x; e < total; e += TOPM_SEL_THREADS) {
      const int r = e / F, f = e - r * F;
      cp_async4(dst + r * ld + f, src + e);
    }
  }
}

// Stages chunk c (when below c_end) into `dst`. With `tma` (F = 32, the
// corpus 16-byte aligned, the buffer 1024-byte aligned) thread 0 loads the
// chunk as boxes of the tensor map (min(chunk, TOPM_BOX) rows each,
// 1024-byte aligned in the buffer), unpadded rows with the 128-byte
// swizzle (16-byte piece k of row r at piece k ^ (r % 8); rows past N come
// as zeros), counted on the mbarrier `bar`; else every thread issues
// cp.async copies into padded rows and commits a group, also an empty one,
// so that a thread's groups count chunks.
__device__ __forceinline__ void topm_issue(const float* __restrict__ corpus,
                                           const CUtensorMap* map, int c,
                                           int c_end, int chunk, int N, int F,
                                           int ld, bool vec, bool tma,
                                           float* dst,
                                           unsigned long long* bar) {
  if (tma) {
    if (threadIdx.x == 0 && c < c_end) {
      mbar_expect(bar, chunk * 32 * 4);
      for (int b = 0; b < chunk; b += TOPM_BOX)
        tma_load_rows(dst + b * 32, map, c * chunk + b, bar);
    }
    return;
  }
  if (c < c_end) {
    const int r0 = c * chunk;
    topm_stage_chunk(dst, corpus + (size_t)r0 * F, min(chunk, N - r0), F, ld,
                     vec);
  }
  cp_async_commit();
}

// Thread t's four rows (t / 4 + 64 j) of a staged chunk against its query
// (in registers), the chains interleaved; rows past the chunk are clamped
// for the reads and not stored. Each chain is the sort route's topm_dot,
// term for term. FX is F when it is known at compile time (32), else 0.
// With `swz` the rows are the TMA route's (stride 32, 128-byte swizzle;
// the four rows share r % 8, so one XOR serves them).
template <int FX>
__device__ __forceinline__ void topm_dots(
    const float (&q)[FX ? FX : TOPM_FMAX], const float* stage, int ld,
    bool swz, int chunk, int n, int F, float* sc) {
  constexpr int FM = FX ? FX : TOPM_FMAX;
  const int t = threadIdx.x;
  const int x = swz ? (t >> 2) & 7 : 0;
  const float* rows[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    rows[j] = stage + min((t >> 2) + 64 * j, chunk - 1) * ld;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < FM / 4; ++k)
    if (FX || 4 * k < F) {
      float4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = *reinterpret_cast<const float4*>(rows[j] + 4 * (k ^ x));
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(q[4 * k], v[j].x, acc[j]);
      if (FX || 4 * k + 1 < F)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[j] = fmaf(q[4 * k + 1], v[j].y, acc[j]);
      if (FX || 4 * k + 2 < F)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[j] = fmaf(q[4 * k + 2], v[j].z, acc[j]);
      if (FX || 4 * k + 3 < F)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[j] = fmaf(q[4 * k + 3], v[j].w, acc[j]);
    }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = (t >> 2) + 64 * j;
    if (r < n) sc[r] = topm_fill(acc[j]);
  }
}

// Stage build only: thread 0's cycles inside an expression, summed into
// slot k, and the number of times, into slot k + 1.
#ifdef TOPM_STAGES
#define TOPM_SPAN(k, expr)                                               \
  do {                                                                   \
    const long long topm_s = clock64();                                  \
    expr;                                                                \
    if (threadIdx.x == 0) {                                              \
      topm_d[k] += clock64() - topm_s;                                   \
      topm_d[(k) + 1] += 1;                                              \
    }                                                                    \
  } while (0)
#else
#define TOPM_SPAN(k, expr) \
  do {                     \
    expr;                  \
  } while (0)
#endif

// --------------------------------------------------- the scoring phases
//
// The select route's body (topm_select_body) stages chunks, selects and
// merges; a phase fills the score tile of each staged chunk. Its members:
// kTma (rows may come by TMA: F = 32 at compile time), kPair (two CTAs an
// SM at up to 2 keys a lane, by registers), queries() (a CTA's, TOPM_QB
// at compile time for the dot scan), load() (the query side, once a CTA,
// after the first copies are issued; the loop's first barrier makes
// shared stores visible) and score() (all threads; scores of rows [0, n)
// of the staged chunk for query sq at sc[sq * lds + row]).

// The dot phase: thread t's four rows of a chunk against query t % 4.
template <int FX>
struct TopmDot {
  static constexpr bool kTma = FX == 32;
  static constexpr bool kPair = FX != 0;
  const float* qv;
  float q[FX ? FX : TOPM_FMAX];

  __device__ __forceinline__ int queries(const TopmLayout&) const {
    return TOPM_QB;
  }

  __device__ __forceinline__ void load(float*, const TopmLayout&, int q0,
                                       int Q, int F) {
    const int dq = threadIdx.x & (TOPM_QB - 1);
#pragma unroll
    for (int f = 0; f < (FX ? FX : TOPM_FMAX); ++f)
      q[f] = (FX || f < F) && q0 + dq < Q
                 ? __ldg(qv + (size_t)(q0 + dq) * F + f) : 0.0f;
  }

  __device__ __forceinline__ void score(const float* stage, int ld, bool swz,
                                        int chunk, int n, int F, float* sc,
                                        int lds TOPM_STAGE_PARAM) const {
    topm_dots<FX>(q, stage, ld, swz, chunk, n, F,
                  sc + (threadIdx.x & (TOPM_QB - 1)) * lds);
  }
};

// The NTN scan's query side and FCN stack, as the launcher passes them.
struct TopmNtnArgs {
  const float* uq;                      // [Q, K, F]
  const float* dq;                      // [Q, K]
  const float* fcn_w[SIMGNN_MAX_FCN];   // [d_l, d_{l+1}]
  const float* fcn_b[SIMGNN_MAX_FCN];   // [d_{l+1}]
  int fcn_dims[SIMGNN_MAX_FCN + 1];     // K .. 1
  int n_fcn;
  int K;
};

// Words of the NTN phase's shared region: uq [qb][K][ru4(F)] (rows zero-
// padded), dq [qb][K], then each FCN layer's W [d_l * d_{l+1}] and b
// [d_{l+1}], every piece rounded up to 4 words.
static long long topm_ntn_words(int qb, int K, int F, const int* dims,
                                int n_fcn) {
  long long words = (long long)qb * K * topm_ru4(F) + topm_ru4(qb * K);
  for (int l = 0; l < n_fcn; ++l)
    words += topm_ru4(dims[l] * dims[l + 1]) + topm_ru4(dims[l + 1]);
  return words;
}

// The NTN phase: the exact pre-sigmoid NTN+FCN logit of each (query, row).
// The query side (uq, dq) and the FCN weights are copied into shared
// memory once a CTA. Work items are (query, group of 32 RT rows): warp w
// takes items w, w + 8, ..., and its lanes hold RT rows each (loaded once
// a group), so every uq, dq and weight read is one address for the whole
// warp (a broadcast) and one 16-byte uq load feeds 4 RT FMAs.
// A lane runs KB slices' chains at once and folds each slice's
// activation into the first FCN layer's accumulators as it comes (layer
// 1's chain for output o runs over the slices in order), so no
// activation is stored. Each chain is the sort route's, op for op:
// a_k = fmaf(uq[k][f], row[f], .) over f from 0, act_k = relu(a_k +
// dq[k]), h_o = fmaf(act_k, W[k][o], .) over k from 0, then + b, relu but
// on the last layer. SERVED is the SimGNN-AIDS head (F 32, K 16, FCN
// 16-8-4-1) at compile time, two rows and eight slices' chains a lane;
// else F <= 64, any K and FCN layers after K up to TOPM_NTN_HIDDEN wide,
// one row and four chains a lane. Both take the register budget of one
// CTA an SM (the plan spreads the CTAs one an SM): at up to 128 registers
// the scheduler placed two on some SMs, and those SMs set the launch's
// time. What bounds the phase is latency: a warp keeps four chains in
// flight and waits on its uq loads, at eight warps an SM.
template <bool SERVED>
struct TopmNtn {
  static constexpr bool kTma = SERVED;
  static constexpr bool kPair = false;
  static constexpr int RT = SERVED ? 2 : 1;       // rows a lane
  static constexpr int FQ = SERVED ? 8 : TOPM_FMAX / 4;   // float4 a row
  static constexpr int KB = SERVED ? 8 : 4;       // slices' chains at once
  const TopmNtnArgs* a;
  const float* us;      // [qb][K][FP]
  const float* ds;      // [qb][K]
  const float* fw;      // FCN W and b of each layer
  int qb, K, FP;

  __device__ __forceinline__ int queries(const TopmLayout& L) const {
    return L.qb;
  }

  __device__ __forceinline__ void load(float* smem, const TopmLayout& L,
                                       int q0, int Q, int F) {
    qb = L.qb;
    K = SERVED ? 16 : a->K;
    FP = SERVED ? 32 : topm_ru4(F);
    float* u = smem + L.ntn_off;
    float* d = u + qb * K * FP;
    float* w = d + topm_ru4(qb * K);
    us = u;
    ds = d;
    fw = w;
    const int t = threadIdx.x, kf = K * FP;
    if (SERVED && ((uintptr_t)a->uq & 15) == 0) {
      // [qb][16][32] as float4s: the query's rows are contiguous
      for (int x = t; x < qb * kf / 4; x += TOPM_SEL_THREADS) {
        const int q = x / (kf / 4);
        reinterpret_cast<float4*>(u)[x] =
            q0 + q < Q ? __ldg(reinterpret_cast<const float4*>(
                             a->uq + (size_t)q0 * kf) + x)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    } else {
      for (int x = t; x < qb * kf; x += TOPM_SEL_THREADS) {
        const int q = x / kf, k = (x - q * kf) / FP, f = x - q * kf - k * FP;
        u[x] = q0 + q < Q && f < F
                   ? __ldg(a->uq + ((size_t)(q0 + q) * K + k) * F + f)
                   : 0.0f;
      }
    }
    for (int x = t; x < qb * K; x += TOPM_SEL_THREADS)
      d[x] = q0 + x / K < Q ? __ldg(a->dq + (size_t)q0 * K + x) : 0.0f;
#pragma unroll 1
    for (int l = 0; l < a->n_fcn; ++l) {
      const int din = a->fcn_dims[l], dout = a->fcn_dims[l + 1];
      for (int x = t; x < din * dout; x += TOPM_SEL_THREADS)
        w[x] = __ldg(a->fcn_w[l] + x);
      w += topm_ru4(din * dout);
      for (int x = t; x < dout; x += TOPM_SEL_THREADS)
        w[x] = __ldg(a->fcn_b[l] + x);
      w += topm_ru4(dout);
    }
  }

  // The slices' chains and the first FCN layer's sums over the slices
  // (the AIDS head: h [RT][8]).
  __device__ __forceinline__ void aids_slices(
      const float4 (&row)[RT][FQ], int sq, float (&h)[RT][8]) const {
    constexpr int K = 16, FP = 32, H1 = 8;
    const float* u = us + sq * K * FP;
    const float* d = ds + sq * K;
#pragma unroll
    for (int j = 0; j < RT; ++j)
#pragma unroll
      for (int o = 0; o < H1; ++o) h[j][o] = 0.0f;
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += KB) {
      float acc[RT][KB];
#pragma unroll
      for (int j = 0; j < RT; ++j)
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) acc[j][kk] = 0.0f;
#pragma unroll
      for (int p = 0; p < FP / 4; ++p) {
        float4 v[KB];
#pragma unroll
        for (int kk = 0; kk < KB; ++kk)
          v[kk] = *reinterpret_cast<const float4*>(u + (k0 + kk) * FP + 4 * p);
#pragma unroll
        for (int kk = 0; kk < KB; ++kk)
#pragma unroll
          for (int j = 0; j < RT; ++j) {
            acc[j][kk] = fmaf(v[kk].x, row[j][p].x, acc[j][kk]);
            acc[j][kk] = fmaf(v[kk].y, row[j][p].y, acc[j][kk]);
            acc[j][kk] = fmaf(v[kk].z, row[j][p].z, acc[j][kk]);
            acc[j][kk] = fmaf(v[kk].w, row[j][p].w, acc[j][kk]);
          }
      }
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        const float dk = d[k0 + kk];
        const float4 wa = *reinterpret_cast<const float4*>(fw + (k0 + kk) * H1);
        const float4 wb =
            *reinterpret_cast<const float4*>(fw + (k0 + kk) * H1 + 4);
        const float wk[H1] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          const float act = simgnn_relu(acc[j][kk] + dk);
#pragma unroll
          for (int o = 0; o < H1; ++o) h[j][o] = fmaf(act, wk[o], h[j][o]);
        }
      }
    }
  }

  // The AIDS head's FCN after the slices: layer 1's bias and relu, layers
  // 2 (8 -> 4, relu) and 3 (4 -> 1).
  __device__ __forceinline__ void aids_fcn(const float (&h)[RT][8],
                                           float (&logit)[RT]) const {
    constexpr int K = 16, H1 = 8, H2 = 4;
    const float* b1 = fw + K * H1;
    const float* w2 = b1 + H1;
    const float* b2 = w2 + H1 * H2;
    const float* w3 = b2 + H2;
    const float* b3 = w3 + H2;
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      float x[H1], g[H2];
#pragma unroll
      for (int i = 0; i < H1; ++i) x[i] = simgnn_relu(h[j][i] + b1[i]);
#pragma unroll
      for (int o = 0; o < H2; ++o) {
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < H1; ++i) s = fmaf(x[i], w2[i * H2 + o], s);
        g[o] = simgnn_relu(s + b2[o]);
      }
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < H2; ++i) s = fmaf(g[i], w3[i], s);
      logit[j] = s + b3[0];
    }
  }

  // The slices' chains and the first FCN layer's sums, any head (one row
  // a lane; h [TOPM_NTN_HIDDEN], entries past d_1 stay 0).
  __device__ __forceinline__ void any_slices(const float4 (&row)[RT][FQ],
                                             int sq, int F,
                                             float (&h)[TOPM_NTN_HIDDEN])
      const {
    const float* u = us + sq * K * FP;
    const float* d = ds + sq * K;
    const int d1 = a->fcn_dims[1];
#pragma unroll
    for (int o = 0; o < TOPM_NTN_HIDDEN; ++o) h[o] = 0.0f;
#pragma unroll 1
    for (int k0 = 0; k0 < K; k0 += KB) {
      float acc[KB];
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) acc[kk] = 0.0f;
#pragma unroll
      for (int p = 0; p < FQ; ++p)
        if (4 * p < F) {
          float4 v[KB];
#pragma unroll
          for (int kk = 0; kk < KB; ++kk)
            v[kk] = *reinterpret_cast<const float4*>(
                u + min(k0 + kk, K - 1) * FP + 4 * p);
#pragma unroll
          for (int kk = 0; kk < KB; ++kk)
            acc[kk] = fmaf(v[kk].x, row[0][p].x, acc[kk]);
          if (4 * p + 1 < F)
#pragma unroll
            for (int kk = 0; kk < KB; ++kk)
              acc[kk] = fmaf(v[kk].y, row[0][p].y, acc[kk]);
          if (4 * p + 2 < F)
#pragma unroll
            for (int kk = 0; kk < KB; ++kk)
              acc[kk] = fmaf(v[kk].z, row[0][p].z, acc[kk]);
          if (4 * p + 3 < F)
#pragma unroll
            for (int kk = 0; kk < KB; ++kk)
              acc[kk] = fmaf(v[kk].w, row[0][p].w, acc[kk]);
        }
#pragma unroll
      for (int kk = 0; kk < KB; ++kk)
        if (k0 + kk < K) {
          const float act = simgnn_relu(acc[kk] + d[k0 + kk]);
          const float* wk = fw + (k0 + kk) * d1;
#pragma unroll
          for (int o = 0; o < TOPM_NTN_HIDDEN; ++o)
            if (o < d1) h[o] = fmaf(act, wk[o], h[o]);
        }
    }
  }

  // Any head's FCN after the slices: layer 1's bias (relu but on the last
  // layer), then layers 2.. from registers; the logit is h[0].
  __device__ __forceinline__ float any_fcn(float (&h)[TOPM_NTN_HIDDEN]) const {
    const int n_fcn = a->n_fcn, d1 = a->fcn_dims[1];
    const float* w = fw + topm_ru4(K * d1);
#pragma unroll
    for (int o = 0; o < TOPM_NTN_HIDDEN; ++o)
      if (o < d1) {
        const float s = h[o] + w[o];
        h[o] = n_fcn > 1 ? simgnn_relu(s) : s;
      }
    w += topm_ru4(d1);
#pragma unroll 1
    for (int l = 1; l < n_fcn; ++l) {
      const int din = a->fcn_dims[l], dout = a->fcn_dims[l + 1];
      const float* b = w + topm_ru4(din * dout);
      float nx[TOPM_NTN_HIDDEN];
#pragma unroll
      for (int o = 0; o < TOPM_NTN_HIDDEN; ++o) {
        nx[o] = 0.0f;
        if (o < dout) {
          float s = 0.0f;
#pragma unroll
          for (int i = 0; i < TOPM_NTN_HIDDEN; ++i)
            if (i < din) s = fmaf(h[i], w[i * dout + o], s);
          s += b[o];
          nx[o] = l + 1 < n_fcn ? simgnn_relu(s) : s;
        }
      }
#pragma unroll
      for (int o = 0; o < TOPM_NTN_HIDDEN; ++o) h[o] = nx[o];
      w = b + topm_ru4(dout);
    }
    return h[0];
  }

  __device__ __forceinline__ void score(const float* stage, int ld, bool swz,
                                        int chunk, int n, int F, float* sc,
                                        int lds TOPM_STAGE_PARAM) const {
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int groups = (chunk + 32 * RT - 1) / (32 * RT);
    float4 row[RT][FQ];
    int have = -1;
    for (int it = w; it < qb * groups; it += TOPM_SEL_THREADS / 32) {
      const int g = it % groups, sq = it / groups;
      if (g != have) {
        have = g;
        // row 32 (RT g + j) + lane, clamped for the reads; with `swz` the
        // TMA route's swizzled rows (stride 32)
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          const int r = min(32 * (RT * g + j) + lane, chunk - 1);
          const int x = swz ? r & 7 : 0;
#pragma unroll
          for (int p = 0; p < FQ; ++p)
            if (SERVED || 4 * p < F)
              row[j][p] = *reinterpret_cast<const float4*>(
                  stage + r * ld + 4 * (p ^ x));
        }
      }
      float logit[RT];
      if constexpr (SERVED) {
        float h[RT][8];
        TOPM_SPAN(16, aids_slices(row, sq, h));
        TOPM_SPAN(18, aids_fcn(h, logit));
      } else {
        float h[TOPM_NTN_HIDDEN];
        TOPM_SPAN(16, any_slices(row, sq, F, h));
        TOPM_SPAN(18, logit[0] = any_fcn(h));
      }
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int r = 32 * (RT * g + j) + lane;
        if (r < n) sc[sq * lds + r] = topm_fill(logit[j]);
      }
    }
  }
};

// The select route's body. Grid: ceil(Q / qb) clusters of L.cs CTAs, each
// cluster a group of qb queries (1, 2 or 4). CTA `rank` of a cluster walks
// chunks [rank * per, (rank + 1) * per) of the corpus; the phase scores
// each staged chunk into the score tile; the W = 8 / qb warps of query
// w % qb select over the chunk's 32-row groups, warp w those of index
// w / qb mod W. From the second chunk on, a warp also filters with the
// bound that the query's warps in the cluster publish (read through
// distributed shared memory once a chunk). At the end the CTA's W warps
// of a query merge pairwise, every CTA pushes its lists into rank 0's
// shared memory before a cluster barrier, and rank 0 merges them and
// writes the first M keys.
template <int R, class Phase>
__device__ __forceinline__ void topm_select_body(
    Phase& ph, const float* __restrict__ corpus, int Q, int N, int F, int M,
    float* __restrict__ out_s, int* __restrict__ out_i, const TopmLayout& L,
    const CUtensorMap* map, int vec, int use_tma) {
  constexpr int KP = 32 * R;
  extern __shared__ __align__(16) float smem[];
  TOPM_CLOCK_START();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int qb = ph.queries(L);
  const int q0 = (int)(blockIdx.x / L.cs) * qb;

  const int chunk = L.chunk, ld = L.ld, lds = L.lds;
  const int cs = min(L.cs, TOPM_MAX_CS);
  const int nchunks = (N + chunk - 1) / chunk;
  const int c_begin = rank * L.per;
  const int c_end = min(c_begin + L.per, nchunks);
  float* const stage0 = smem + L.stage_off[0];
  float* const stage1 = smem + L.stage_off[1];
  float* sc = smem + L.sc_off;
  float2* queue = (float2*)(smem + L.queue_off) + w * TOPM_QUEUE;
  unsigned long long* thr = (unsigned long long*)(smem + L.thr_off);
  unsigned long long* bar = (unsigned long long*)(smem + L.bar_off);

  // The TMA route where the launcher built a tensor map (F = 32) and both
  // buffers sit on the swizzle's 1024-byte boundary.
  const bool tma = Phase::kTma && use_tma &&
                   ((topm_smem(stage0) | topm_smem(stage1)) & 1023) == 0;
  const int row_ld = tma ? 32 : ld;
  if (tma) {
    if (t == 0) {
      mbar_init(bar);
      mbar_init(bar + 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  // Every CTA's published bounds exist before any peer reads them: each
  // warp writes its first one and the CTA arrives before any load is in
  // flight (a release waits for the thread's loads, the staging copies
  // too); a warp waits before its first read of a peer's.
  if (lane == 0)
    *(volatile unsigned long long*)(thr + w) = key_pack(topm_sentinel());
  cluster_arrive();
  topm_issue(corpus, map, c_begin, c_end, chunk, N, F, ld, vec, tma, stage0,
             bar);
  topm_issue(corpus, map, c_begin + 1, c_end, chunk, N, F, ld, vec, tma,
             stage1, bar + 1);
  TOPM_LAP(12);

  ph.load(smem, L, q0, Q, F);

  // Warp w selects for query sq = w % qb, part w / qb of its W warps.
  const int W = TOPM_SEL_THREADS / 32 / qb;
  const int sq = w % qb, part = w / qb;
  const bool sq_live = q0 + sq < Q;
  WarpTopM<R> sel;
  sel.init(M);
  // The filter threshold: the list's own key M - 1, or a bound the
  // cluster's W cs warps of the query give together: each publishes its
  // key `pub` = ceil(M / (W cs)) - 1, so the worst of their published keys
  // has at least M keys at or before it.
  const int pub = (M + W * cs - 1) / (W * cs) - 1;
  TopmKey ft = topm_sentinel();
  int cnt = 0;
  bool joined = false;
  TOPM_LAP(0);
  for (int c = c_begin; c < c_end; ++c) {
    const int use = c - c_begin;
    float* const stage = use & 1 ? stage1 : stage0;
    if (tma) mbar_wait(bar + (use & 1), (use >> 1) & 1);
    else cp_async_wait_group<1>();
    __syncthreads();
    TOPM_LAP(1);
    const int r0 = c * chunk, n = min(chunk, N - r0);
    ph.score(stage, row_ld, tma, chunk, n, F, sc, lds TOPM_STAGE_ARG);
    __syncthreads();
    TOPM_LAP(2);
    topm_issue(corpus, map, c + 2, c_end, chunk, N, F, ld, vec, tma, stage,
               bar + (use & 1));
    TOPM_LAP(11);
    if (c > c_begin) {
      if (!joined) {
        cluster_wait();
        joined = true;
      }
      if (sq_live) {
        // entry e (lane, lane + 32) is warp sq + qb (e % W) of rank e / W;
        // the worst of the W cs keys bounds the query (a stale key bounds
        // it too)
        TopmKey o = topm_first();
        for (int e = lane; e < W * cs; e += 32) {
          const TopmKey x = key_unpack(
              *(volatile unsigned long long*)cluster.map_shared_rank(
                  thr + sq + qb * (e % W), e / W));
          if (key_before(o, x)) o = x;
        }
        o = warp_worst(o);
        if (key_before(o, ft)) ft = o;
      }
    }
    TOPM_LAP(8);
    if (sq_live) {
      for (int g = 32 * part; g < n; g += 32 * W) {
        const int r = g + lane;
        const bool real = r < n;
        const TopmKey k{real ? sc[sq * lds + r] : 0.0f, r0 + r};
        cnt = topm_offer(queue, cnt, real, k, ft, lane);
        if (cnt >= 32) {
          __syncwarp();
          TOPM_SPAN(9, cnt = topm_drain(sel, queue, cnt, lane));
          if (key_before(sel.t, ft)) ft = sel.t;
          const TopmKey mine = sel.at(pub);
          if (lane == 0)
            *(volatile unsigned long long*)(thr + w) = key_pack(mine);
        }
      }
    }
    TOPM_STAGE_SYNC();
    TOPM_LAP(3);
  }
  if (!joined) cluster_wait();
  if (sq_live && cnt > 0) {
    __syncwarp();
    TOPM_SPAN(9, cnt = topm_drain(sel, queue, cnt, lane));
  }
  TOPM_LAP(4);

  // The query's W warps merge pairwise (at level d, part p + d's list
  // into part p, through one of the query's W / 2 list slots); part 0
  // pushes the CTA's list into rank 0's gather buffer (rank 0 keeps its
  // own in registers).
  const int slots = W / 2;
  float* gs = smem + L.gather_off + (rank * TOPM_QB + sq) * KP;
  int* gi = (int*)(smem + L.gather_off + cs * TOPM_QB * KP) +
            (rank * TOPM_QB + sq) * KP;
  for (int d = slots; d >= 1; d >>= 1) {
    const int slot = sq * slots + (part & (d - 1));
    float* ls = smem + L.list_off + slot * KP;
    int* li = (int*)(smem + L.list_off + TOPM_QB * KP) + slot * KP;
    if (d < slots) __syncthreads();
    if (sq_live && part >= d && part < 2 * d) sel.store(ls, li, lane);
    __syncthreads();
    if (sq_live && part < d) sel.merge(ls, li, lane);
  }
  if (part == 0 && sq_live && rank > 0)
    sel.store(cluster.map_shared_rank(gs, 0), cluster.map_shared_rank(gi, 0),
              lane);
  TOPM_LAP(5);
  cluster_arrive();
  cluster_wait();
  TOPM_LAP(6);
  if (rank > 0) {
    TOPM_CLOCK_END(blockIdx.x);
    return;
  }

  // Rank 0: part p < P = min(W, cs) of a query merges the lists of ranks
  // p, p + P, ... (part 0 holds rank 0's); then the P parts merge
  // pairwise as above and part 0 writes the first M keys.
  const int stride = TOPM_QB * KP;
  const int P = W < cs ? W : cs;
  if (sq_live && part < P) {
    if (part > 0) sel.load(gs + part * stride, gi + part * stride, lane);
    for (int p = part + P; p < cs; p += P)
      sel.merge(gs + p * stride, gi + p * stride, lane);
  }
  for (int d = P / 2; d >= 1; d >>= 1) {
    const int slot = sq * slots + (part & (d - 1));
    float* ls = smem + L.list_off + slot * KP;
    int* li = (int*)(smem + L.list_off + TOPM_QB * KP) + slot * KP;
    if (d < P / 2) __syncthreads();
    if (sq_live && part >= d && part < 2 * d) sel.store(ls, li, lane);
    __syncthreads();
    if (sq_live && part < d) sel.merge(ls, li, lane);
  }
  if (sq_live && part == 0)
    sel.write(out_s + (size_t)(q0 + sq) * M, out_i + (size_t)(q0 + sq) * M,
              M, lane);
  TOPM_LAP(7);
  TOPM_CLOCK_END(blockIdx.x);
}

template <int R, int FX>
__global__ void __launch_bounds__(TOPM_SEL_THREADS,
                                  R <= 2 && TopmDot<FX>::kPair ? 2 : 1)
topm_select_kernel(const float* __restrict__ qv,
                   const float* __restrict__ corpus, int Q, int N, int F,
                   int M, float* __restrict__ out_s, int* __restrict__ out_i,
                   TopmLayout L, const __grid_constant__ CUtensorMap map,
                   int vec, int use_tma) {
  TopmDot<FX> ph;
  ph.qv = qv;
  topm_select_body<R>(ph, corpus, Q, N, F, M, out_s, out_i, L, &map, vec,
                      use_tma);
}

template <int R, bool SERVED>
__global__ void __launch_bounds__(TOPM_SEL_THREADS,
                                  R <= 2 && TopmNtn<SERVED>::kPair ? 2 : 1)
topm_ntn_select_kernel(const __grid_constant__ TopmNtnArgs a,
                       const float* __restrict__ corpus, int Q, int N, int F,
                       int M, float* __restrict__ out_s,
                       int* __restrict__ out_i, TopmLayout L,
                       const __grid_constant__ CUtensorMap map, int vec,
                       int use_tma) {
  TopmNtn<SERVED> ph;
  ph.a = &a;
  topm_select_body<R>(ph, corpus, Q, N, F, M, out_s, out_i, L, &map, vec,
                      use_tma);
}

// Whether a plan's layout fits the scan: its partition covers the corpus
// and each buffer (the NTN region of `ntn_words`, 0 for the dot scan)
// starts 16-byte aligned inside the launch's shared memory.
static bool topm_layout_ok(const TopmLayout* L, int N, int F, int M,
                           int max_chunk, long long ntn_words) {
  const int kp = 32 * L->r;
  if ((L->r != 1 && L->r != 2 && L->r != 4 && L->r != 8) || M > kp ||
      (L->r > 1 && M <= kp / 2))
    return false;
  if (L->chunk < 1 || L->chunk > max_chunk || L->ld < ((F + 3) & ~3) ||
      L->ld % 4 != 0 || L->lds < L->chunk || L->cs < 1 ||
      L->cs > TOPM_MAX_CS || (L->cs & (L->cs - 1)) != 0 || L->per < 1 ||
      (long long)L->cs * L->per * L->chunk < N ||
      (L->qb != 1 && L->qb != 2 && L->qb != TOPM_QB))
    return false;
  const int start[9] = {L->stage_off[0], L->stage_off[1], L->sc_off,
                        L->queue_off,    L->thr_off,      L->bar_off,
                        L->list_off,     L->gather_off,   L->ntn_off};
  const long long words[9] = {L->chunk * L->ld,
                              L->chunk * L->ld,
                              TOPM_QB * L->lds,
                              (TOPM_SEL_THREADS / 32) * 2 * TOPM_QUEUE,
                              (TOPM_SEL_THREADS / 32) * 2,
                              4,
                              2 * TOPM_QB * kp,
                              2 * L->cs * TOPM_QB * kp,
                              ntn_words};
  for (int a = 0; a < 9; ++a)
    if (start[a] < 0 || start[a] % 4 != 0 ||
        start[a] + words[a] > L->smem_words)
      return false;
  return true;
}

typedef void (*TopmSelectKernel)(const float*, const float*, int, int, int,
                                 int, float*, int*, TopmLayout, CUtensorMap,
                                 int, int);
typedef void (*TopmNtnSelectKernel)(TopmNtnArgs, const float*, int, int, int,
                                    int, float*, int*, TopmLayout,
                                    CUtensorMap, int, int);

typedef CUresult (*TopmEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time (null where the installed
// CUDA lacks it).
static TopmEncodeTiled topm_encoder() {
  static TopmEncodeTiled fn = nullptr;
  static bool asked = false;
  if (!asked) {
    asked = true;
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = (TopmEncodeTiled)p;
  }
  return fn;
}

// The TMA route's tensor map of a [N, 32] float32 corpus: boxes of
// min(chunk, TOPM_BOX) rows, the 128-byte swizzle, rows past N read as
// zeros. False where it cannot be built (or a chunk is not whole boxes).
static bool topm_tensor_map(CUtensorMap* map, const float* corpus, int N,
                            int chunk) {
  const TopmEncodeTiled enc = topm_encoder();
  const int rows = chunk < TOPM_BOX ? chunk : TOPM_BOX;
  if (!enc || chunk % rows != 0) return false;
  const cuuint64_t dims[2] = {32, (cuuint64_t)N};
  const cuuint64_t strides[1] = {32 * sizeof(float)};
  const cuuint32_t box[2] = {32, (cuuint32_t)rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)corpus, dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The instantiation for R keys a lane and width F (compile-time F = 32).
static TopmSelectKernel topm_select_kernel_for(int r, int F) {
  const bool f32 = F == 32;
  switch (r) {
    case 1: return f32 ? topm_select_kernel<1, 32> : topm_select_kernel<1, 0>;
    case 2: return f32 ? topm_select_kernel<2, 32> : topm_select_kernel<2, 0>;
    case 4: return f32 ? topm_select_kernel<4, 32> : topm_select_kernel<4, 0>;
    default: return f32 ? topm_select_kernel<8, 32> : topm_select_kernel<8, 0>;
  }
}

// The NTN instantiation for R keys a lane: the AIDS head compiled, or any.
static TopmNtnSelectKernel topm_ntn_kernel_for(int r, bool served) {
  switch (r) {
    case 1: return served ? topm_ntn_select_kernel<1, true>
                          : topm_ntn_select_kernel<1, false>;
    case 2: return served ? topm_ntn_select_kernel<2, true>
                          : topm_ntn_select_kernel<2, false>;
    case 4: return served ? topm_ntn_select_kernel<4, true>
                          : topm_ntn_select_kernel<4, false>;
    default: return served ? topm_ntn_select_kernel<8, true>
                           : topm_ntn_select_kernel<8, false>;
  }
}

static cudaLaunchConfig_t topm_cluster_config(int cs, int ctas, size_t smem,
                                              cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)ctas, 1, 1);
  cfg.blockDim = dim3(TOPM_SEL_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// One select-route launch of `kern`, either scan's instantiation (`first`:
// the dot scan's qv, or the NTN scan's TopmNtnArgs): ceil(Q / qb)
// clusters of cs CTAs; rows staged by TMA where `tma_ok` (F = 32 compiled
// in), F = 32 and the corpus is 16-byte aligned.
template <class Kern, class First>
static int topm_select(Kern kern, const First& first, const float* corpus,
                       int Q, int N, int F, int M, float* out_s, int* out_i,
                       const TopmLayout* L, bool tma_ok, void* stream) {
  const size_t smem = (size_t)L->smem_words * 4;
  cudaError_t err = simgnn_set_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = topm_cluster_config(
      L->cs, (int)(((long long)Q + L->qb - 1) / L->qb * L->cs), smem, attr);
  cfg.stream = (cudaStream_t)stream;
  const int vec = F % 4 == 0 && ((uintptr_t)corpus & 15) == 0;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  const int tma = tma_ok && F == 32 && vec &&
                  topm_tensor_map(&map, corpus, N, L->chunk);
  err = cudaLaunchKernelEx(&cfg, kern, first, corpus, Q, N, F, M, out_s,
                           out_i, *L, map, vec, tma);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

static bool topm_select_shapes_ok(int Q, int N, int F, int M,
                                  const TopmLayout* L, int max_chunk,
                                  long long ntn_words) {
  return Q > 0 && N > 0 && F > 0 && F <= TOPM_FMAX && M > 0 && M <= N &&
         M <= TOPM_MAX_SELECT &&
         topm_layout_ok(L, N, F, M, max_chunk, ntn_words) &&
         ((long long)Q + L->qb - 1) / L->qb * L->cs <= INT_MAX;
}

// The dot scan's select route: out [Q, M] scores and indices in one launch.
extern "C" int topm_select_launch(const float* qv, const float* corpus, int Q,
                                  int N, int F, int M, float* out_s,
                                  int* out_i, const TopmLayout* L,
                                  void* stream) {
  if (!topm_select_shapes_ok(Q, N, F, M, L, TOPM_MAX_CHUNK, 0))
    return (int)cudaErrorInvalidValue;
  return topm_select(topm_select_kernel_for(L->r, F), qv, corpus, Q, N, F, M,
                     out_s, out_i, L, true, stream);
}

// An NTN head: K slices and an FCN stack from K to 1, every width 1 to
// SIMGNN_MAX_HEAD.
static bool topm_ntn_head_ok(int K, const SimgnnParams* P) {
  if (K < 1 || P->n_fcn < 1 || P->n_fcn > SIMGNN_MAX_FCN ||
      P->fcn_dims[0] != K || P->fcn_dims[P->n_fcn] != 1)
    return false;
  for (int l = 0; l <= P->n_fcn; ++l)
    if (P->fcn_dims[l] < 1 || P->fcn_dims[l] > SIMGNN_MAX_HEAD) return false;
  return true;
}

// The SimGNN-AIDS head (F 32, K 16, FCN 16-8-4-1), compiled in.
static bool topm_ntn_served(int F, int K, const SimgnnParams* P) {
  return F == 32 && K == 16 && P->n_fcn == 3 && P->fcn_dims[1] == 8 &&
         P->fcn_dims[2] == 4 && P->fcn_dims[3] == 1;
}

// The NTN scan's select route: the NTN phase holds the AIDS head, or FCN
// layers after K up to TOPM_NTN_HIDDEN wide.
extern "C" int topm_ntn_select_launch(const float* uq, const float* dq,
                                      const float* corpus, int Q, int N,
                                      int F, int K, int M, float* out_s,
                                      int* out_i, const SimgnnParams* P,
                                      const TopmLayout* L, void* stream) {
  if (!topm_ntn_head_ok(K, P)) return (int)cudaErrorInvalidValue;
  const bool served = topm_ntn_served(F, K, P);
  for (int l = 1; l <= P->n_fcn; ++l)
    if (!served && P->fcn_dims[l] > TOPM_NTN_HIDDEN)
      return (int)cudaErrorInvalidValue;
  if (!topm_select_shapes_ok(
          Q, N, F, M, L, TOPM_NTN_MAX_CHUNK,
          topm_ntn_words(L->qb, K, F, P->fcn_dims, P->n_fcn)))
    return (int)cudaErrorInvalidValue;
  TopmNtnArgs a;
  memset(&a, 0, sizeof(a));
  a.uq = uq;
  a.dq = dq;
  for (int l = 0; l < P->n_fcn; ++l) {
    a.fcn_w[l] = P->fcn_w[l];
    a.fcn_b[l] = P->fcn_b[l];
  }
  for (int l = 0; l <= P->n_fcn; ++l) a.fcn_dims[l] = P->fcn_dims[l];
  a.n_fcn = P->n_fcn;
  a.K = K;
  return topm_select(topm_ntn_kernel_for(L->r, served), a, corpus, Q, N, F,
                     M, out_s, out_i, L, served, stream);
}

template <class Kern>
static int topm_occupancy(Kern kern, int cs, int smem_bytes, int* clusters) {
  cudaError_t err = simgnn_set_smem(kern, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = topm_cluster_config(cs, cs, smem_bytes, attr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
}

// Clusters of `cs` select-route CTAs with `smem_bytes` of dynamic shared
// memory the current device holds at once: the dot scan's instantiation
// (head 0: R keys a lane, width F) or the NTN scan's (head 1: any head,
// 2: the AIDS head).
extern "C" int topm_max_clusters(int r, int F, int head, int cs,
                                 int smem_bytes, int* clusters) {
  if (head == 0)
    return topm_occupancy(topm_select_kernel_for(r, F), cs, smem_bytes,
                          clusters);
  return topm_occupancy(topm_ntn_kernel_for(r, head == 2), cs, smem_bytes,
                        clusters);
}

// ------------------------------------------- the sort route's C interface

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

// The dot scan's sort route (block pass, then merge pass).
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
