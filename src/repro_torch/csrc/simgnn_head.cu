// Fused NTN + FCN + sigmoid head on graph-embedding pairs for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/simgnn_head.py
// (simgnn_head, body _kernel): per pair, the K bilinear slices
// h1^T W[k] h2, the linear term V [h1; h2] + b, ReLU, the FCN stack and the
// sigmoid; only the [B] scores reach global memory.
//
// What bounds it on this card: the float32 FMA rate (about 17 K MAC per
// pair at F = 32, K = 16) against 256 bytes of embeddings per pair. One
// warp scores one pair through `ntn_fcn_warp`, eight pairs per CTA; the
// NTN tensor (64 KB at F = 32, K = 16) is read through L1, which every
// CTA of an SM shares. A pair's score depends on nothing but its own two
// rows, so it is the same bits at any batch size: the exact 1-vs-N scan
// and the two-stage rerank score a shared pair identically. The kernel
// takes any B; no padding to a block multiple.
#include "simgnn_common.cuh"

__global__ void __launch_bounds__(SIMGNN_THREADS)
simgnn_head_kernel(const float* __restrict__ h1, const float* __restrict__ h2,
                   float* __restrict__ out, long long B, SimgnnParams P) {
  __shared__ float buf[SIMGNN_WARPS][2 * SIMGNN_MAX_HEAD];
  const int warp = threadIdx.x >> 5;
  const long long pair = (long long)blockIdx.x * SIMGNN_WARPS + warp;
  if (pair >= B) return;                  // whole warps leave together
  const int F = P.gcn_dims[P.n_gcn];
  const float s = ntn_fcn_warp(h1 + pair * F, h2 + pair * F, P, buf[warp]);
  if ((threadIdx.x & 31) == 0) out[pair] = s;
}

extern "C" int simgnn_head_launch(const float* h1, const float* h2,
                                  float* out, long long B,
                                  const SimgnnParams* P, void* stream) {
  const long long blocks = (B + SIMGNN_WARPS - 1) / SIMGNN_WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  simgnn_head_kernel<<<(unsigned)blocks, SIMGNN_THREADS, 0,
                       (cudaStream_t)stream>>>(h1, h2, out, B, *P);
  return (int)cudaGetLastError();
}
