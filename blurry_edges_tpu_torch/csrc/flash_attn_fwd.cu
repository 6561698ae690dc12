// Flash attention forward: exact softmax attention over one (batch, head)
// without materialising the L x L probabilities; writes the output and one
// log-sum-exp a query row for the backward.
//
// Replaces the TPU kernel of the library flash attention that
// blurry_edges_tpu/models/global_stage.py::flash_attention_fn calls:
// jax/experimental/pallas/ops/tpu/flash_attention.py::_flash_attention_impl
// (its forward pallas_call). No bias, no mask, no causal mask, no dropout;
// sm_scale = 1/sqrt(head_dim). The library keeps the row max m and row sum l
// lane-broadcast for its backward; here one lse = m + log(l) a row, (B, H, L).
//
// Bound on an H100 at the global trainer's chunk shape (B = 2, H = 8,
// L = 4,096, D = 16). The function: 2*D for q.k and 2*D for p*v a (query,
// key) pair (a multiply-add counts 2), 4*L^2*D a head, 17.2 GFLOP; one
// exponential a pair, 268 M; 4 MB of q, k, v, o and lse (1.3 us at
// 3.35 TB/s).
// - On the float32 FMA pipe (the design before this one): 17.2 GFLOP at
//   67 TFLOP/s, 0.256 ms.
// - On the tensor cores in 3xTF32 (this design): 3 x 17.2 GFLOP at 495 TFLOP/s
//   dense TF32, 0.104 ms; the exponentials on the SFU, 16 a clock an SM,
//   268 M / (132 x 16 x 1.83 GHz) = 0.069 ms, at the clock the 495 TFLOP/s
//   assumes (2,048 TF32 operations a clock an SM). The bound is 0.104 ms.
//
// Design (FlashAttention-2's, on wgmma in 3xTF32; helpers and operand
// layouts in flash_mma.cuh):
// - One block of two warpgroups (8 warps) for each (128 query rows, batch x
//   head); a warpgroup owns 64 rows, a warp 16. The q fragments, scaled by
//   scale * log2(e) so S comes out in the softmax's base-2 units, are split
//   into TF32 big and small parts once and stay in registers as wgmma's A.
// - K and V tiles of 64 keys are copied by cp.async into a two-stage raw
//   ring in shared memory while the previous tile is computed. Once
//   a tile lands, the block splits it, each value once, into big and small
//   parts in the core-matrix layouts wgmma reads as B: K over d, V over keys
//   (V transposed, since TF32 wgmma takes K-major B only).
// - S = q K^T (m64n64k8, 6 wgmma a tile) and O = P V (m64n16k8, 24 a tile)
//   in 3xTF32: float32-grade, as the reference's float32 products, where one
//   TF32 pass misses the 1e-5 tolerance on o and lse by over 30x
//   (tests/test_torch_flash_tf32.py).
// - The online softmax runs on the S fragments: the row max over a quad by
//   __shfl_xor_sync, exp2 by the SFU, O and the row sums rescaled once a
//   tile; each thread keeps partial row sums, reduced over the quad at the
//   end. P goes from S's D fragment to P V's A fragment in registers.
// - A tile's P V is summed in fresh accumulators and added to O by an FFMA.
//   The tensor cores round their sums toward zero, so one accumulator
//   carried over thousands of keys drifts with L; a tile's 24 products and
//   float32 adds between tiles stay at the float32 level.
// - Why wgmma and not mma.sync.m16n8k8 (this kernel's first design): wgmma
//   is the only way to the card's full TF32 rate, and the block splits the
//   shared K/V tile once for all its warps, where mma.sync's fragments had
//   every warp split the whole tile itself; on the card the mma.sync design
//   was the slower (PERF.md).
// - Ragged L: tiles past L are zero-filled by cp.async, scores of keys past
//   L (in the last tile only) are -inf, rows past L are computed and not
//   stored.
// Nothing carries over between blocks; no atomics. The row max is taken of
// the scaled scores, so any sign of scale works; lse = m * ln(2) + log(l).

#include <cuda_runtime.h>
#include <math.h>

#include "flash_mma.cuh"

namespace {

using namespace flash_mma;

constexpr int kD = 16;        // head dim, the only one the wrapper passes
constexpr int kWG = 2;          // warpgroups a block
constexpr int kThreads = 128 * kWG;
constexpr int kRowsQ = 64 * kWG;       // query rows a block
constexpr int kTileK = 64;             // keys a tile
constexpr int kRaw = 2 * kTileK * kD;  // floats of one raw stage: K, then V
// shared memory (static, under 48 KB): two raw stages, then K big, K small, V big, V small
constexpr int kKb = 2 * kRaw, kKs = kKb + kTileK * kD;
constexpr int kVb = kKs + kTileK * kD, kVs = kVb + kTileK * kD;
constexpr int kSmemBytes = (kVs + kTileK * kD) * 4;

// Split a landed raw K/V tile into big and small parts, each value once for
// the block, in wgmma's B layouts: K as B over d, V as B over keys.
__device__ __forceinline__ void split_tile(const float* raw, float* smem) {
  uint32_t* su = reinterpret_cast<uint32_t*>(smem);
  for (int i = threadIdx.x; i < 2 * kTileK * 4; i += kThreads) {
    const bool is_v = i >= kTileK * 4;
    const int r = (i >> 2) & (kTileK - 1), c = (i & 3) * 4;
    const float4 x = *reinterpret_cast<const float4*>(raw + (is_v ? kTileK * kD : 0) + r * kD + c);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t b, sm;
      split(xs[e], b, sm);
      const int at = is_v ? at_over_rows(r, c + e) : at_over_d(r, c + e);
      su[(is_v ? kVb : kKb) + at] = b;
      su[(is_v ? kVs : kKs) + at] = sm;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int L, float scale) {
  __shared__ __align__(16) float smem[kSmemBytes / 4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t head = (size_t)blockIdx.y * L;  // first row of this (b, h)
  const float* kg = k + head * kD;
  const float* vg = v + head * kD;
  const int row = blockIdx.x * kRowsQ + warp * 16 + g;  // and row + 8

  // q * scale * log2(e) as A over d: k-step kk holds d = 4t + 2kk in slot t,
  // 4t + 2kk + 1 in t + 4
  const float c = scale * kLog2e;
  uint32_t q_big[2][4], q_small[2][4];
  {
    float4 x[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      x[r] = row + 8 * r < L
          ? *reinterpret_cast<const float4*>(q + (head + row + 8 * r) * kD + 4 * t)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      x[r] = make_float4(x[r].x * c, x[r].y * c, x[r].z * c, x[r].w * c);
    }
    split_a(x[0].x, x[1].x, x[0].y, x[1].y, q_big[0], q_small[0]);
    split_a(x[0].z, x[1].z, x[0].w, x[1].w, q_big[1], q_small[1]);
  }

  float m[2] = {-INFINITY, -INFINITY};  // running row max of S, rows g and g + 8
  float l[2] = {0.f, 0.f};              // this thread's share of the row sums
  float acc[8];  // O: acc[4 ng + e] is row g + 8 (e >> 1), d = 4t + 2 (e & 1) + ng
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;

  const int n_tiles = (L + kTileK - 1) / kTileK;
  stage_rows<kTileK>(smem, kg, 0, L);
  stage_rows<kTileK>(smem + kTileK * kD, vg, 0, L);
  cp_async_commit();

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {  // the next raw tile into the other stage
      float* next = smem + ((it + 1) & 1) * kRaw;
      stage_rows<kTileK>(next, kg, (it + 1) * kTileK, L);
      stage_rows<kTileK>(next + kTileK * kD, vg, (it + 1) * kTileK, L);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();     // for every thread, and every warpgroup is done with the last tile
    split_tile(smem + (it & 1) * kRaw, smem);
    fence_async_smem();
    __syncthreads();
    const int nk = min(kTileK, L - it * kTileK);

    // S = q K^T; s[4j + e] is row g + 8 (e >> 1), key 8j + 2t + (e & 1)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma3(s, q_big[kk], q_small[kk], smem + kKb + kk * 512, smem + kKs + kk * 512);
    wg_commit();
    wg_wait();
    fence_regs(s);

    // online softmax on the fragments; keys past L (in the last tile only)
    // are -inf
    if (nk < kTileK) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (8 * (i >> 2) + 2 * t + (i & 1) >= nk) s[i] = -INFINITY;
    }
    float mx[2] = {m[0], m[1]}, corr[2];
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // over the quad that shares the row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = ex2(m[r] - mx[r]);  // 0 on the first tile
      m[r] = mx[r];                 // finite: key 0 of a tile is in range
      l[r] *= corr[r];
    }
    // P, split as A over keys: k-step j takes keys 8j + 2t (slot t) and
    // 8j + 2t + 1 (t + 4), i.e. s[4j], s[4j + 2] and s[4j + 1], s[4j + 3]
    uint32_t pb[8][4], ps[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = ex2(s[4 * j + e] - m[e >> 1]);
        l[e >> 1] += s[4 * j + e];
      }
      split_a(s[4 * j], s[4 * j + 2], s[4 * j + 1], s[4 * j + 3], pb[j], ps[j]);
    }

    // P V of this tile into fresh sums, then O = O * corr + P V
    float pv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) pv[i] = 0.f;
    fence_regs(pv);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j)
      wgmma3(pv, pb[j], ps[j], smem + kVb + j * 128, smem + kVs + j * 128);
    wg_commit();
    wg_wait();
    fence_regs(pv);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = fmaf(acc[i], corr[(i >> 1) & 1], pv[i]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int rr = row + 8 * r;
    if (rr < L) {
      const float inv = 1.f / lr;
      *reinterpret_cast<float4*>(o + (head + rr) * kD + 4 * t) = make_float4(
          acc[2 * r] * inv, acc[4 + 2 * r] * inv, acc[2 * r + 1] * inv, acc[5 + 2 * r] * inv);
      if (t == 0) lse[head + rr] = m[r] * kLn2 + logf(lr);
    }
  }
}

}  // namespace

// q, k, v, o: (BH, L, 16) float32, contiguous; lse: (BH, L). BH = batch x
// heads. Returns cudaGetLastError() after the launch.
extern "C" int flash_attn_fwd_launch(const float* q, const float* k,
                                     const float* v, float* o, float* lse,
                                     int BH, int L, float scale,
                                     cudaStream_t stream) {
  if (BH > 0 && L > 0) {
    const dim3 grid((L + kRowsQ - 1) / kRowsQ, BH);
    flash_fwd_kernel<<<grid, kThreads, 0, stream>>>(q, k, v, o, lse, L, scale);
  }
  return (int)cudaGetLastError();
}
