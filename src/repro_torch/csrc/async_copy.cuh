// Asynchronous global-to-shared copies (cp.async, sm_80 and later) shared
// by the port's kernels: one 4- or 16-byte copy a call, commit, waits, and
// an n-float copy spread over a range of threads.
//
// A copy lands in shared memory once the issuing thread has waited for it
// (cp_async_wait_all); other threads see it after a barrier that follows
// that wait.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n floats from global to shared memory by cp.async on threads tid, tid +
// step, ...: 16 bytes a copy when both ends are 16-byte aligned and n a
// multiple of 4.
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int n, int tid, int step) {
  if (n % 4 == 0 && ((uintptr_t)src & 15) == 0 &&
      (__cvta_generic_to_shared(dst) & 15) == 0) {
    for (int i = 4 * tid; i < n; i += 4 * step) cp_async16(dst + i, src + i);
  } else {
    for (int i = tid; i < n; i += step) cp_async4(dst + i, src + i);
  }
}
