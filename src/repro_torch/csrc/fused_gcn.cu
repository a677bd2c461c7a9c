// Fused GCN stack + Att pooling (graph embeddings) for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_gcn.py
// (fused_gcn_att, body _kernel): per padded graph, every GCN layer
// H' = relu(A' (H W + b)) * mask on the pre-normalised A', then the Att
// pooling of paper Eq. 3; only the [B, F] embeddings reach global memory.
//
// What bounds it on this card: the float32 FMA rate at buckets up to 64
// nodes (the dense layer-0 product on one-hot features and the dense
// aggregation over the padded block dominate), and latency with one CTA per
// graph. A', H and HW stay in shared memory while they fit the block's
// opt-in limit (80 KB at bucket 64, 192 KB at bucket 128); the
// power-of-two oversize buckets beyond that keep them in a per-block global
// scratch buffer the wrapper allocates, which L2 mostly holds.
//
// One CTA per graph, and every output element owned by one thread that
// sums its terms in node order, makes a graph's embedding bit-identical
// whatever its batch companions and whatever bucket it is padded to: pad
// nodes add exact zeros after the real terms (A' pad columns and the mask
// are zero). The embedding cache relies on this.
#include "simgnn_common.cuh"

// A', HW and H of one graph: the part that moves to global scratch.
__host__ __device__ static inline size_t gcn_big_floats(int n,
                                                        const SimgnnParams& P) {
  return (size_t)n * n + 2 * (size_t)n * P.f_max;
}

static size_t gcn_small_floats(int n, const SimgnnParams& P) {
  const int F = P.gcn_dims[P.n_gcn];
  return 2 * (size_t)F + 2 * (size_t)n;                // mean, c, att, mask
}

// Floats of global scratch each graph needs: 0 when A', H and HW fit in
// the block's shared memory.
extern "C" long long fused_gcn_scratch_floats(int n, const SimgnnParams* P) {
  const size_t all = (gcn_big_floats(n, *P) + gcn_small_floats(n, *P)) * 4;
  return all <= (size_t)simgnn_smem_optin() ? 0
                                            : (long long)gcn_big_floats(n, *P);
}

__global__ void __launch_bounds__(SIMGNN_THREADS)
fused_gcn_kernel(const float* __restrict__ adj, const float* __restrict__ feats,
                 const float* __restrict__ mask_g, float* __restrict__ out,
                 int n, int f0, float* scratch, SimgnnParams P) {
  extern __shared__ float smem[];
  const long b = blockIdx.x;
  const int F = P.gcn_dims[P.n_gcn];
  float* big = scratch ? scratch + b * gcn_big_floats(n, P) : smem;
  float* a = big;
  float* hw = a + (size_t)n * n;
  float* h = hw + (size_t)n * P.f_max;
  float* small = scratch ? smem : big + gcn_big_floats(n, P);
  float* mean = small;
  float* c = mean + F;
  float* att = c + F;
  float* mask = att + n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) mask[i] = mask_g[b * n + i];
  const float* ag = adj + b * n * n;
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) a[i] = __ldg(ag + i);
  __syncthreads();
  gcn_stack(P, n, nullptr, feats + b * n * f0, hw, h,
            [&](const float* x, int f, float* y) {
              dense_aggregate(a, x, n, f, mask, y);
            });
  segment_att_pool(h, n, F, mask, nullptr, 1, P.att_w, mean, c, att,
                   out + b * F);
}

extern "C" int fused_gcn_launch(const float* adj, const float* feats,
                                const float* mask, float* out, int B, int n,
                                int f0, float* scratch, const SimgnnParams* P,
                                void* stream) {
  size_t floats = gcn_small_floats(n, *P);
  if (scratch == nullptr) floats += gcn_big_floats(n, *P);
  const size_t smem = floats * 4;
  cudaError_t err = simgnn_set_smem(fused_gcn_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  fused_gcn_kernel<<<B, SIMGNN_THREADS, smem, (cudaStream_t)stream>>>(
      adj, feats, mask, out, n, f0, scratch, *P);
  return (int)cudaGetLastError();
}
