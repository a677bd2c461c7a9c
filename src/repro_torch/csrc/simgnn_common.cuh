// Device functions shared by the port's SimGNN kernels (sparse_pair.cu,
// packed_pair.cu, fused_pair.cu, fused_gcn.cu, simgnn_head.cu,
// retrieval.cu): the CUDA counterpart of the forward bodies in
// src/repro/kernels/common.py.
//
// Every function here is block-level: all threads of the block call it, it
// strides its work over threadIdx.x, and it ends with __syncthreads() so its
// output is visible to the next stage. Pointers may address shared or
// global memory (the fused kernel keeps oversize graphs in a global scratch
// buffer). Arithmetic is float32 throughout with full-precision expf, tanhf
// and sqrtf (the sources are built without --use_fast_math).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SIMGNN_THREADS 256
#define SIMGNN_WARPS (SIMGNN_THREADS / 32)
#define SIMGNN_MAX_GCN 8      // GCN layers a launch takes
#define SIMGNN_MAX_FCN 8      // FCN layers a launch takes
#define SIMGNN_MAX_HEAD 64    // widest NTN K / FCN layer a launch takes

// Weights of one SimGNN model, float32 and contiguous, in the JAX tree
// layout: gcn w [f_l, f_{l+1}], att w [F, F], ntn w [K, F, F], v [K, 2F],
// b [K], fcn w [d_l, d_{l+1}]. Passed to the kernels by value.
struct SimgnnParams {
  const float* gcn_w[SIMGNN_MAX_GCN];
  const float* gcn_b[SIMGNN_MAX_GCN];
  const float* fcn_w[SIMGNN_MAX_FCN];
  const float* fcn_b[SIMGNN_MAX_FCN];
  const float* att_w;
  const float* ntn_w;
  const float* ntn_v;
  const float* ntn_b;
  int gcn_dims[SIMGNN_MAX_GCN + 1];   // f0 (labels) .. f_L
  int fcn_dims[SIMGNN_MAX_FCN + 1];   // K .. 1
  int n_gcn;
  int n_fcn;
  int ntn_k;
  int f_max;                          // widest GCN output
};

// Lets the Python binding check that its ctypes mirror has this layout.
extern "C" int simgnn_params_size(void) { return (int)sizeof(SimgnnParams); }

__device__ __forceinline__ float simgnn_sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// ReLU that keeps NaN, as jnp.maximum and torch.relu do (fmaxf would turn a
// NaN embedding into a finite score).
__device__ __forceinline__ float simgnn_relu(float x) {
  return x < 0.0f ? 0.0f : x;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// hw[i, j] = sum_k h[i, k] w[k, j] + b[j] for i < n.
__device__ void dense_transform(const float* h, int n, int fin,
                                const float* __restrict__ w,
                                const float* __restrict__ b, int fout,
                                float* hw) {
  for (int idx = threadIdx.x; idx < n * fout; idx += blockDim.x) {
    const int i = idx / fout, j = idx - i * fout;
    const float* hr = h + (size_t)i * fin;
    float acc = 0.0f;
    for (int k = 0; k < fin; ++k) acc = fmaf(hr[k], __ldg(w + k * fout + j), acc);
    hw[idx] = acc + __ldg(b + j);
  }
  __syncthreads();
}

// First layer with int labels: hw[i, j] = w[labels[i], j] + b[j] (the
// one-hot product as a row gather).
__device__ void label_transform(const int* labels, int n,
                                const float* __restrict__ w,
                                const float* __restrict__ b, int fout,
                                float* hw) {
  for (int idx = threadIdx.x; idx < n * fout; idx += blockDim.x) {
    const int i = idx / fout, j = idx - i * fout;
    hw[idx] = __ldg(w + labels[i] * fout + j) + __ldg(b + j);
  }
  __syncthreads();
}

// Packed-CSR aggregation + ReLU∘mask: h[i] = relu(sum_k nw[k*nb+i] *
// hw[nbr[k*nb+i]] + sum_{e: ovr[e]==i} ovw[e] * hw[ovs[e]]) * mask[i].
// Each (node, feature) output is owned by one thread and summed in a fixed
// order, so the result is deterministic (no atomics).
__device__ void csr_aggregate(const float* hw, int nb, int f, int d,
                              const int* nbr, const float* nw, int e_ov,
                              const int* ovs, const int* ovr,
                              const float* ovw, const float* mask, float* h) {
  for (int idx = threadIdx.x; idx < nb * f; idx += blockDim.x) {
    const int i = idx / f, j = idx - i * f;
    float acc = nw[i] * hw[nbr[i] * f + j];
    for (int k = 1; k < d; ++k) {
      const int s = k * nb + i;
      acc = fmaf(nw[s], hw[nbr[s] * f + j], acc);
    }
    float ov = 0.0f;
    for (int e = 0; e < e_ov; ++e)
      if (ovr[e] == i) ov = fmaf(ovw[e], hw[ovs[e] * f + j], ov);
    h[idx] = simgnn_relu(acc + ov) * mask[i];
  }
  __syncthreads();
}

// Dense aggregation + ReLU∘mask: h[i] = relu(sum_k a[i, k] hw[k]) * mask[i].
__device__ void dense_aggregate(const float* a, const float* hw, int n, int f,
                                const float* mask, float* h) {
  for (int idx = threadIdx.x; idx < n * f; idx += blockDim.x) {
    const int i = idx / f, j = idx - i * f;
    const float* ar = a + (size_t)i * n;
    float acc = 0.0f;
    for (int k = 0; k < n; ++k) acc = fmaf(ar[k], hw[(size_t)k * f + j], acc);
    h[idx] = simgnn_relu(acc) * mask[i];
  }
  __syncthreads();
}

// In-kernel A' = D^-1/2 (A + I) D^-1/2 under the node mask, from a raw
// [n, n] adjacency in global memory into `a`; `inv` is [n] scratch.
// Degrees of 0/1 adjacencies are small integers, so they are exact.
__device__ void normalize_block(const float* __restrict__ adj,
                                const float* mask, int n, float* a,
                                float* inv) {
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, j = idx - i * n;
    a[idx] = (__ldg(adj + idx) + (i == j ? 1.0f : 0.0f)) * (mask[i] * mask[j]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float* ar = a + (size_t)i * n;
    float deg = 0.0f;
    for (int k = 0; k < n; ++k) deg += ar[k];
    inv[i] = deg > 0.0f ? 1.0f / sqrtf(fmaxf(deg, 1e-12f)) : 0.0f;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, j = idx - i * n;
    a[idx] = a[idx] * inv[i] * inv[j];
  }
  __syncthreads();
}

// Att pooling per segment (paper Eq. 3, DESIGN.md §8): node n belongs to
// segment seg[n] (all to segment 0 when seg is null) and counts only when
// mask[n] != 0. h [n, f] -> hg [p, f]; empty segments give zeros.
// Scratch: mean [p*f], c [p*f], att [n].
__device__ void segment_att_pool(const float* h, int n, int f,
                                 const float* mask, const int* seg, int p,
                                 const float* __restrict__ att_w, float* mean,
                                 float* c, float* att, float* hg) {
  for (int idx = threadIdx.x; idx < p * f; idx += blockDim.x) {
    const int q = idx / f, j = idx - q * f;
    float sum = 0.0f, cnt = 0.0f;
    for (int k = 0; k < n; ++k) {
      const float s = (seg == nullptr || seg[k] == q) ? mask[k] : 0.0f;
      sum = fmaf(s, h[(size_t)k * f + j], sum);
      cnt += s;
    }
    mean[idx] = sum / fmaxf(cnt, 1.0f);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < p * f; idx += blockDim.x) {
    const int q = idx / f, g = idx - q * f;
    float acc = 0.0f;
    for (int j = 0; j < f; ++j) acc = fmaf(mean[q * f + j], __ldg(att_w + j * f + g), acc);
    c[idx] = tanhf(acc);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    float a = 0.0f;
    if (mask[k] != 0.0f) {
      const float* cq = c + (seg == nullptr ? 0 : seg[k]) * f;
      const float* hk = h + (size_t)k * f;
      float dot = 0.0f;
      for (int j = 0; j < f; ++j) dot = fmaf(hk[j], cq[j], dot);
      a = simgnn_sigmoid(dot) * mask[k];
    }
    att[k] = a;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < p * f; idx += blockDim.x) {
    const int q = idx / f, j = idx - q * f;
    float sum = 0.0f;
    for (int k = 0; k < n; ++k) {
      const float s = (seg == nullptr || seg[k] == q) ? mask[k] : 0.0f;
      sum = fmaf(s, att[k] * h[(size_t)k * f + j], sum);
    }
    hg[idx] = sum;
  }
  __syncthreads();
}

// NTN + FCN + sigmoid for one pair, computed by one warp. h1/h2 [F];
// buf is [2 * SIMGNN_MAX_HEAD] per-warp scratch. Returns the score on
// every lane.
__device__ float ntn_fcn_warp(const float* h1, const float* h2,
                              const SimgnnParams& P, float* buf) {
  const int lane = threadIdx.x & 31;
  const int F = P.gcn_dims[P.n_gcn];
  const int K = P.ntn_k;
  for (int k = 0; k < K; ++k) {
    const float* wk = P.ntn_w + (size_t)k * F * F;
    float bil = 0.0f;
    for (int g = lane; g < F; g += 32) {
      float t = 0.0f;
      for (int i = 0; i < F; ++i) t = fmaf(h1[i], __ldg(wk + i * F + g), t);
      bil = fmaf(t, h2[g], bil);
    }
    float lin = 0.0f;
    const float* vk = P.ntn_v + (size_t)k * 2 * F;
    for (int j = lane; j < 2 * F; j += 32)
      lin = fmaf(j < F ? h1[j] : h2[j - F], __ldg(vk + j), lin);
    bil = warp_sum(bil);
    lin = warp_sum(lin);
    if (lane == 0) buf[k] = simgnn_relu(bil + lin + __ldg(P.ntn_b + k));
  }
  __syncwarp();
  float* cur = buf;
  float* nxt = buf + SIMGNN_MAX_HEAD;
  for (int l = 0; l < P.n_fcn; ++l) {
    const int din = P.fcn_dims[l], dout = P.fcn_dims[l + 1];
    const float* w = P.fcn_w[l];
    for (int o = lane; o < dout; o += 32) {
      float acc = 0.0f;
      for (int i = 0; i < din; ++i) acc = fmaf(cur[i], __ldg(w + i * dout + o), acc);
      acc += __ldg(P.fcn_b[l] + o);
      nxt[o] = (l + 1 < P.n_fcn) ? simgnn_relu(acc) : acc;
    }
    __syncwarp();
    float* tmp = cur; cur = nxt; nxt = tmp;
  }
  const float s = simgnn_sigmoid(cur[0]);
  __syncwarp();
  return s;
}

// Runs the GCN stack of one side on a packed or padded block: layer 0 from
// int labels (labels != null) or from dense feats h0 [n, f0]; each later
// layer's H·W from `hbuf`. HW goes to `hwbuf`, H back to `hbuf`, so two
// buffers serve the whole stack. `aggregate` is called as
// aggregate(hw, f_out, h) and applies the layer's A' and ReLU∘mask.
template <typename Agg>
__device__ void gcn_stack(const SimgnnParams& P, int n, const int* labels,
                          const float* h0, float* hwbuf, float* hbuf,
                          Agg aggregate) {
  for (int l = 0; l < P.n_gcn; ++l) {
    const int fin = P.gcn_dims[l], fout = P.gcn_dims[l + 1];
    if (l == 0 && labels != nullptr)
      label_transform(labels, n, P.gcn_w[0], P.gcn_b[0], fout, hwbuf);
    else
      dense_transform(l == 0 ? h0 : hbuf, n, fin, P.gcn_w[l], P.gcn_b[l],
                      fout, hwbuf);
    aggregate(hwbuf, fout, hbuf);
  }
}

// Dynamic shared memory a block may opt in to on the current device (0
// when the device cannot be queried).
static inline int simgnn_smem_optin() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return limit;
}

// Returns cudaErrorInvalidValue for a dynamic shared-memory request beyond
// what the card allows a block, else sets the kernel's opt-in limit.
template <typename K>
static cudaError_t simgnn_set_smem(K kernel, size_t bytes) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)limit) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
