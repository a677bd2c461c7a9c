// Packed-sparse (packed-CSR) SimGNN pair-score megakernel for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sparse_pair.py
// (sparse_pair_score, body _kernel): per packed tile, both sides' GCN stack
// aggregated from the host-built A' ELLPACK planes + COO overflow list,
// segment Att pooling over the P pair slots, NTN, FCN and sigmoid; only the
// [T, P] scores reach global memory.
//
// What bounds it on this card: the work is tiny (about 1.7 M MAC and 5 KB
// of input per tile at SimGNN-AIDS widths), so the float32 FMA rate (67
// TFLOP/s outside the tensor cores) bounds it at a few microseconds per
// request and device memory does not matter. In practice latency does: one
// CTA per tile gives ~130 CTAs for a 256-pair request, one wave on 132 SMs.
// The design keeps every intermediate in shared memory (H and HW ping-pong
// in two [NB, F_max] buffers, the tile's edge planes staged once per side),
// skips all-pad tiles, and scores each live pair slot with one warp.
// Register tiling and tensor-core products are left to later work.
#include "simgnn_common.cuh"

struct SparseSide {
  const int16_t* nbr;     // [T, NB*D] ELL senders (plane-major)
  const float* nw;        // [T, NB*D] A' weights (0 at pad slots)
  const int16_t* ovs;     // [T, E_ov] COO overflow senders
  const int16_t* ovr;     // [T, E_ov] COO overflow receivers
  const float* ovw;       // [T, E_ov] overflow weights
  const int32_t* labels;  // [T, NB]
  const float* mask;      // [T, NB]
  const int32_t* seg;     // [T, NB] pair slot of each node
};

extern "C" int sparse_side_size(void) { return (int)sizeof(SparseSide); }

static size_t sparse_smem_bytes(int nb, int d, int e_ov, int p,
                                const SimgnnParams& P) {
  const int F = P.gcn_dims[P.n_gcn], E = nb * d;
  const size_t floats = 2 * (size_t)nb * P.f_max   // HW, H
                        + 4 * (size_t)p * F          // hg (2 sides), mean, c
                        + 2 * (size_t)nb             // att, mask
                        + E + e_ov                   // ELL / COO weights
                        + SIMGNN_WARPS * 2 * SIMGNN_MAX_HEAD;
  const size_t ints = E + 2 * (size_t)e_ov + 2 * (size_t)nb;
  return (floats + ints) * 4;
}

__global__ void __launch_bounds__(SIMGNN_THREADS)
sparse_pair_kernel(SparseSide s1, SparseSide s2, const float* __restrict__ pmask,
                   float* __restrict__ out, int nb, int d, int e_ov, int p,
                   SimgnnParams P) {
  extern __shared__ float smem[];
  __shared__ int any_live;
  const long t = blockIdx.x;
  const int F = P.gcn_dims[P.n_gcn], E = nb * d;
  const float* pm = pmask + t * p;
  if (threadIdx.x == 0) {
    int live = 0;
    for (int q = 0; q < p; ++q) live |= pm[q] != 0.0f;
    any_live = live;
  }
  __syncthreads();
  if (!any_live) {                      // pad tile: exact zeros
    for (int q = threadIdx.x; q < p; q += blockDim.x) out[t * p + q] = 0.0f;
    return;
  }
  float* hw = smem;
  float* h = hw + (size_t)nb * P.f_max;
  float* hg = h + (size_t)nb * P.f_max;     // [2, p, F]
  float* mean = hg + 2 * p * F;
  float* c = mean + p * F;
  float* att = c + p * F;
  float* mask = att + nb;
  float* nw = mask + nb;
  float* ovw = nw + E;
  float* head = ovw + e_ov;
  int* nbr = (int*)(head + SIMGNN_WARPS * 2 * SIMGNN_MAX_HEAD);
  int* ovs = nbr + E;
  int* ovr = ovs + e_ov;
  int* labels = ovr + e_ov;
  int* seg = labels + nb;

  for (int side = 0; side < 2; ++side) {
    const SparseSide& S = side ? s2 : s1;
    for (int i = threadIdx.x; i < E; i += blockDim.x) {
      nbr[i] = S.nbr[t * E + i];
      nw[i] = S.nw[t * E + i];
    }
    for (int i = threadIdx.x; i < e_ov; i += blockDim.x) {
      ovs[i] = S.ovs[t * e_ov + i];
      ovr[i] = S.ovr[t * e_ov + i];
      ovw[i] = S.ovw[t * e_ov + i];
    }
    for (int i = threadIdx.x; i < nb; i += blockDim.x) {
      labels[i] = S.labels[t * nb + i];
      mask[i] = S.mask[t * nb + i];
      seg[i] = S.seg[t * nb + i];
    }
    __syncthreads();
    gcn_stack(P, nb, labels, nullptr, hw, h,
              [&](const float* x, int f, float* y) {
                csr_aggregate(x, nb, f, d, nbr, nw, e_ov, ovs, ovr, ovw, mask, y);
              });
    segment_att_pool(h, nb, F, mask, seg, p, P.att_w, mean, c, att,
                     hg + side * p * F);
  }
  const int warp = threadIdx.x >> 5;
  for (int q = warp; q < p; q += SIMGNN_WARPS) {
    float s = 0.0f;
    if (pm[q] != 0.0f)
      s = ntn_fcn_warp(hg + q * F, hg + (p + q) * F, P,
                       head + warp * 2 * SIMGNN_MAX_HEAD) * pm[q];
    if ((threadIdx.x & 31) == 0) out[t * p + q] = s;
  }
}

extern "C" int sparse_pair_score_launch(const SparseSide* s1,
                                        const SparseSide* s2,
                                        const float* pmask, float* out, int T,
                                        int nb, int d, int e_ov, int p,
                                        const SimgnnParams* P, void* stream) {
  const size_t smem = sparse_smem_bytes(nb, d, e_ov, p, *P);
  cudaError_t err = simgnn_set_smem(sparse_pair_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  sparse_pair_kernel<<<T, SIMGNN_THREADS, smem, (cudaStream_t)stream>>>(
      *s1, *s2, pmask, out, nb, d, e_ov, p, *P);
  return (int)cudaGetLastError();
}
