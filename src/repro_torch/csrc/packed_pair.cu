// Packed-dense SimGNN pair-score megakernel for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/packed_pair.py
// (packed_pair_score, body _kernel): per packed tile, both sides' raw
// block-diagonal [NB, NB] adjacency normalized in the kernel to
// D^-1/2 (A + I) D^-1/2 under the node mask, the GCN stack with dense
// aggregation A'·(HW), segment Att pooling over the P pair slots, NTN, FCN
// and sigmoid; only the [T, P] scores reach global memory.
//
// What bounds it on this card: the float32 FMA rate. Each tile side reads
// 16 KB of adjacency once, but the dense aggregation multiplies the whole
// block (mostly structural zeros) at every layer, ~3.5 M MAC per tile.
// The design keeps A' (16 KB at NB=64), H and HW in shared memory, reads
// the adjacency once per side, skips all-pad tiles, and scores each live
// pair slot with one warp. Tensor-core products are left to later work.
#include "simgnn_common.cuh"

struct PackedSide {
  const float* adj;       // [T, NB, NB] raw block-diagonal adjacency
  const int32_t* labels;  // [T, NB]
  const float* mask;      // [T, NB]
  const int32_t* seg;     // [T, NB]
};

extern "C" int packed_side_size(void) { return (int)sizeof(PackedSide); }

static size_t packed_smem_bytes(int nb, int p, const SimgnnParams& P) {
  const int F = P.gcn_dims[P.n_gcn];
  const size_t floats = (size_t)nb * nb                // A'
                        + 2 * (size_t)nb * P.f_max     // HW, H
                        + 4 * (size_t)p * F            // hg (2 sides), mean, c
                        + 3 * (size_t)nb               // att, mask, inv
                        + SIMGNN_WARPS * 2 * SIMGNN_MAX_HEAD;
  return (floats + 2 * (size_t)nb) * 4;                // + labels, seg
}

__global__ void __launch_bounds__(SIMGNN_THREADS)
packed_pair_kernel(PackedSide s1, PackedSide s2, const float* __restrict__ pmask,
                   float* __restrict__ out, int nb, int p, SimgnnParams P) {
  extern __shared__ float smem[];
  __shared__ int any_live;
  const long t = blockIdx.x;
  const int F = P.gcn_dims[P.n_gcn];
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
  float* a = smem;
  float* hw = a + (size_t)nb * nb;
  float* h = hw + (size_t)nb * P.f_max;
  float* hg = h + (size_t)nb * P.f_max;     // [2, p, F]
  float* mean = hg + 2 * p * F;
  float* c = mean + p * F;
  float* att = c + p * F;
  float* mask = att + nb;
  float* inv = mask + nb;
  float* head = inv + nb;
  int* labels = (int*)(head + SIMGNN_WARPS * 2 * SIMGNN_MAX_HEAD);
  int* seg = labels + nb;

  for (int side = 0; side < 2; ++side) {
    const PackedSide& S = side ? s2 : s1;
    for (int i = threadIdx.x; i < nb; i += blockDim.x) {
      labels[i] = S.labels[t * nb + i];
      mask[i] = S.mask[t * nb + i];
      seg[i] = S.seg[t * nb + i];
    }
    __syncthreads();
    normalize_block(S.adj + t * nb * nb, mask, nb, a, inv);
    gcn_stack(P, nb, labels, nullptr, hw, h,
              [&](const float* x, int f, float* y) {
                dense_aggregate(a, x, nb, f, mask, y);
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

extern "C" int packed_pair_score_launch(const PackedSide* s1,
                                        const PackedSide* s2,
                                        const float* pmask, float* out, int T,
                                        int nb, int p, const SimgnnParams* P,
                                        void* stream) {
  const size_t smem = packed_smem_bytes(nb, p, *P);
  cudaError_t err = simgnn_set_smem(packed_pair_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  packed_pair_kernel<<<T, SIMGNN_THREADS, smem, (cudaStream_t)stream>>>(
      *s1, *s2, pmask, out, nb, p, *P);
  return (int)cudaGetLastError();
}
