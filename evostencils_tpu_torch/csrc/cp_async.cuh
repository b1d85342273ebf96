// 4-byte cp.async copies from device memory into shared memory, shared by
// the kernels that stage their windows with them (csrc/transfer.cu,
// csrc/rbgs.cu, csrc/rbgs_var.cu, csrc/rbgs_sys.cu and, through
// pipeline3d.cuh, the 3D kernels).  Rows of 2047, 1023 or 255 floats are
// only 4-byte aligned, so a copy moves one float.

#pragma once

#include <cuda_runtime.h>

namespace {

// 4 bytes from src to shared dst without waiting; zeros when !in (src is
// then not read).
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait for every copy this thread issued.
__device__ __forceinline__ void copy_wait_all() {
  copy_commit();
  copy_wait<0>();
}

}  // namespace
