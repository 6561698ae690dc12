// cp.async copies from device memory into shared memory, shared by the
// flash kernels (flash_mma.cuh) and the wedge kernels (wedge_colors.cu,
// wedge_render.cu).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// a float address's offset in its 16-byte chunk, in floats
__device__ __forceinline__ int misalign(const void* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Queue the copy of src[lo .. hi) into dst[m + lo .. m + hi), m =
// misalign(src), by the lanes of a warp: cp.async of 16 bytes for whole
// chunks, of 4 bytes at the ends. dst is 16-byte aligned and has room for
// round4(m + hi) floats; src[0 .. hi) lands at dst + m whatever the split.
__device__ __forceinline__ void stage_part(float* dst, const float* src, int lo, int hi,
                                           int lane) {
  const int m = misalign(src);
  const float* base = src - m;
  for (int q = (m + lo) / 4 + lane; 4 * q < m + hi; q += 32) {
    const int a = 4 * q;
    if (a >= m + lo && a + 4 <= m + hi) {
      cp_async16(dst + a, base + a, 16);
    } else {
      for (int j = max(a, m + lo); j < min(a + 4, m + hi); ++j) cp_async4(dst + j, base + j, 4);
    }
  }
}

// the whole range src[0 .. n) into dst[m .. m + n)
__device__ __forceinline__ void stage_range(float* dst, const float* src, int n, int lane) {
  stage_part(dst, src, 0, n, lane);
}

}  // namespace async_copy
