// Pieces shared by the tensor-core flash kernels (flash_attn_fwd.cu,
// flash_attn_bwd_dkv.cu, flash_attn_bwd_dq.cu): 3xTF32 products on wgmma,
// the layouts of their operands, and the cp.async copies that stage the
// tiles (async_copy.cuh).
//
// 3xTF32. A float32 x splits into big = tf32(x) and small = tf32(x - big),
// each rounded to nearest, ties away (as cvt.rna); a*b is then taken as
// small_a*big_b + big_a*small_b + big_a*big_b, accumulated in float32. The
// dropped small*small term and the roundings leave about 2^-22 of |a*b|,
// float32-grade, where one TF32 product keeps 2^-11.
//
// wgmma.mma_async m64nNk8 .f32.tf32.tf32, A from registers, B from shared
// memory K-major without swizzle. A warpgroup (4 warps) owns 64 rows, warp w
// of it rows 16w .. 16w + 15; with g = lane / 4, t = lane % 4:
// - A (16 x 8 a warp): a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4),
//   a3 = (g + 8, t + 4);
// - D (16 x N a warp): d[4i + e] = (g + 8 (e >> 1), 8i + 2t + (e & 1));
// - B (8 x N) in core matrices of 8 n-rows x 4 k-slots (16 bytes a row, 128
//   bytes a core matrix): the two core matrices of a k-step 128 bytes apart
//   (the leading byte offset), n-groups of 8 rows 256 bytes apart (the stride
//   byte offset), one k-step after another (core_index).
// A product sums over its k index in any order, so the kernels choose which
// element each k slot holds, the same for both operands:
// - over d (q.k, dO.v): slot t of k-step kk holds d = 4t + 2kk, slot t + 4
//   holds d = 4t + 2kk + 1, so a thread's A slots of a 16-wide row are one
//   float4 (d = 4t .. 4t + 3);
// - over rows (p.v, dS.q): slot t of k-step j holds row 8j + 2t, slot t + 4
//   row 8j + 2t + 1: columns 2t and 2t + 1 of a D fragment, so D (scores,
//   probabilities) is the next product's A in registers;
// - and an N = 16 product holds d = 2r + ng in n-row r of n-group ng, so a
//   thread's D columns are d = 4t .. 4t + 3 (d[4 ng + e] holds
//   d = 4t + 2 (e & 1) + ng).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace flash_mma {

using namespace async_copy;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// cvt.rna.tf32.f32 as two integer instructions: add half a TF32 unit in the
// last place to the magnitude bits, clear the 13 bits TF32 drops. The same
// result for every finite input; ptxas expands cvt.rna.tf32 into ~6
// instructions (checks for NaN and infinity) where the splits are a large
// share of a tile's work.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x -> (big, small), both TF32 bit patterns
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// Split an A fragment given as the four values of a0..a3.
__device__ __forceinline__ void split_a(float a0, float a1, float a2, float a3,
                                        uint32_t (&big)[4], uint32_t (&small)[4]) {
  split(a0, big[0], small[0]);
  split(a1, big[1], small[1]);
  split(a2, big[2], small[2]);
  split(a3, big[3], small[3]);
}

// 2^x by the SFU: one instruction; relative error ~2^-22, far under the
// tolerances (exp2f adds range checks around the same instruction)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------ B layouts

// float index of (k-step, n-row, k-slot) in a B operand of `rows` n-rows
__device__ __forceinline__ int core_index(int kstep, int n, int slot, int rows) {
  return kstep * rows * 8 + (n >> 3) * 64 + (slot >> 2) * 32 + (n & 7) * 4 + (slot & 3);
}

// element (row, d) of a 64 x 16 tile as B of a product over d, rows as n
__device__ __forceinline__ int at_over_d(int row, int d) {
  return core_index((d >> 1) & 1, row, 4 * (d & 1) + (d >> 2), 64);
}

// element (row, d) of a 64 x 16 tile as B of a product over rows, d as n
__device__ __forceinline__ int at_over_rows(int row, int d) {
  return core_index(row >> 3, 8 * (d & 1) + (d >> 1), 4 * (row & 1) + ((row & 7) >> 1), 16);
}

// wgmma shared-memory descriptor of a B operand at p: no swizzle, leading
// byte offset 128, stride byte offset 256
__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// ------------------------------------------------------------ wgmma

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving registers an in-flight wgmma owns
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d += a * B, m64n64k8
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

// d += a * B, m64n32k8
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

// d += a * B, m64n16k8
__device__ __forceinline__ void wgmma_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

// d += a * B in 3xTF32, the small terms first; B's parts at b_big, b_small
template <int N>
__device__ __forceinline__ void wgmma3(float (&d)[N], const uint32_t (&a_big)[4],
                                       const uint32_t (&a_small)[4], const float* b_big,
                                       const float* b_small) {
  if constexpr (N == 32) {
    wgmma_n64(d, a_small, smem_desc(b_big));
    wgmma_n64(d, a_big, smem_desc(b_small));
    wgmma_n64(d, a_big, smem_desc(b_big));
  } else if constexpr (N == 16) {
    wgmma_n32(d, a_small, smem_desc(b_big));
    wgmma_n32(d, a_big, smem_desc(b_small));
    wgmma_n32(d, a_big, smem_desc(b_big));
  } else {
    wgmma_n16(d, a_small, smem_desc(b_big));
    wgmma_n16(d, a_big, smem_desc(b_small));
    wgmma_n16(d, a_big, smem_desc(b_big));
  }
}

// ------------------------------------------------------------ staging

// Copy rows [t0, t0 + kRows) of a (L, 16) float32 array into shared memory,
// 16 floats a row; rows past L become zeros. All threads of the block take
// part.
template <int kRows>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int t0, int L) {
  for (int i = threadIdx.x; i < kRows * 4; i += blockDim.x) {
    const int r = i >> 2, c = (i & 3) * 4;
    const bool in = t0 + r < L;
    cp_async16(dst + r * 16 + c, src + (size_t)(in ? t0 + r : 0) * 16 + c, in ? 16 : 0);
  }
}

// Make this thread's shared-memory stores visible to wgmma (the async
// proxy); a barrier after it makes every thread's visible.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace flash_mma
