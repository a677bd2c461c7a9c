// Bucketed SimGNN pair-score megakernel for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_pair.py
// (fused_pair_score, body _kernel): per padded graph pair, both sides'
// in-kernel normalization D^-1/2 (A + I) D^-1/2, the GCN stack on dense
// one-hot features with dense aggregation, per-graph Att pooling, NTN, FCN
// and sigmoid; only the [B] scores reach global memory.
//
// What bounds it on this card: at buckets up to 64 nodes the float32 FMA
// rate (about 1.4 M MAC and 16 KB of input per pair at bucket 32), and
// latency with one CTA per pair. A', H and HW stay in shared memory while
// they fit the block's opt-in limit (up to bucket 128: 192 KB); beyond it,
// as for the power-of-two oversize buckets of 256 nodes and more, they live
// in a per-block global scratch buffer the wrapper allocates, which L2
// mostly holds. Tensor-core products are left to later work.
#include "simgnn_common.cuh"

struct FusedSide {
  const float* adj;     // [B, N, N] raw adjacency
  const float* feats;   // [B, N, F0] one-hot node features
  const float* mask;    // [B, N]
};

extern "C" int fused_side_size(void) { return (int)sizeof(FusedSide); }

// A', HW and H of one pair: the part that moves to global scratch.
__host__ __device__ static inline size_t fused_big_floats(int n,
                                                          const SimgnnParams& P) {
  return (size_t)n * n + 2 * (size_t)n * P.f_max;
}

static size_t fused_small_floats(int n, const SimgnnParams& P) {
  const int F = P.gcn_dims[P.n_gcn];
  return 4 * (size_t)F + 3 * (size_t)n + SIMGNN_WARPS * 2 * SIMGNN_MAX_HEAD;
}

// Floats of global scratch each pair needs: 0 when A', H and HW fit in the
// block's shared memory.
extern "C" long long fused_pair_scratch_floats(int n, const SimgnnParams* P) {
  const size_t all = (fused_big_floats(n, *P) + fused_small_floats(n, *P)) * 4;
  return all <= (size_t)simgnn_smem_optin() ? 0 : (long long)fused_big_floats(n, *P);
}

__global__ void __launch_bounds__(SIMGNN_THREADS)
fused_pair_kernel(FusedSide s1, FusedSide s2, float* __restrict__ out, int n,
                  int f0, float* scratch, SimgnnParams P) {
  extern __shared__ float smem[];
  const long b = blockIdx.x;
  const int F = P.gcn_dims[P.n_gcn];
  float* big = scratch ? scratch + b * fused_big_floats(n, P) : smem;
  float* a = big;
  float* hw = a + (size_t)n * n;
  float* h = hw + (size_t)n * P.f_max;
  float* small = scratch ? smem : big + fused_big_floats(n, P);
  float* hg = small;                    // [2, F]
  float* mean = hg + 2 * F;
  float* c = mean + F;
  float* att = c + F;
  float* mask = att + n;
  float* inv = mask + n;
  float* head = inv + n;

  for (int side = 0; side < 2; ++side) {
    const FusedSide& S = side ? s2 : s1;
    for (int i = threadIdx.x; i < n; i += blockDim.x) mask[i] = S.mask[b * n + i];
    __syncthreads();
    normalize_block(S.adj + b * n * n, mask, n, a, inv);
    gcn_stack(P, n, nullptr, S.feats + b * n * f0, hw, h,
              [&](const float* x, int f, float* y) {
                dense_aggregate(a, x, n, f, mask, y);
              });
    segment_att_pool(h, n, F, mask, nullptr, 1, P.att_w, mean, c, att,
                     hg + side * F);
  }
  if (threadIdx.x < 32) {
    const float s = ntn_fcn_warp(hg, hg + F, P, head);
    if (threadIdx.x == 0) out[b] = s;
  }
}

extern "C" int fused_pair_score_launch(const FusedSide* s1, const FusedSide* s2,
                                       float* out, int B, int n, int f0,
                                       float* scratch, const SimgnnParams* P,
                                       void* stream) {
  size_t floats = fused_small_floats(n, *P);
  if (scratch == nullptr) floats += fused_big_floats(n, *P);
  const size_t smem = floats * 4;
  cudaError_t err = simgnn_set_smem(fused_pair_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  fused_pair_kernel<<<B, SIMGNN_THREADS, smem, (cudaStream_t)stream>>>(
      *s1, *s2, out, n, f0, scratch, *P);
  return (int)cudaGetLastError();
}
