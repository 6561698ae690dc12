// cp.async copies from device memory into shared memory, shared by the
// flash kernels (flash_mma.cuh) and the wedge render (wedge_render.cu).

#pragma once

#include <cuda_runtime.h>

namespace async_copy {

// 16 bytes global -> shared, asynchronously; the bytes past src_bytes (0 or
// 16) are zero-filled, so a row past the end reads as zeros. Both addresses
// 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

// 4 bytes, for ranges whose ends are not 16-byte aligned
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace async_copy
