// Flash attention backward, dQ, from q, k, v, the output gradient dO, the
// forward's lse and di = rowsum(o * dO), recomputing the probabilities tile
// by tile instead of reading them. dK and dV are the other kernel, in
// flash_attn_bwd_dkv.cu.
//
// Replaces the TPU kernel of the library flash attention that
// blurry_edges_tpu/models/global_stage.py::flash_attention_fn calls
// (jax/experimental/pallas/ops/tpu/flash_attention.py):
// _flash_attention_bwd_dq (its pallas_call, body _flash_attention_dq_kernel).
// As there, di is computed outside the kernel.
//
// With s = scale * q.k, p = exp(s - lse), dP = dO.v, dS = p * (dP - di):
//   dQ = scale * sum over keys of dS * k.
//
// Bound on an H100 at the global trainer's chunk shape (B = 2, H = 8,
// L = 4,096, D = 16). The function: 6*D a (query, key) pair (q.k, dO.v,
// dS*k; a multiply-add counts 2), 25.8 GFLOP; one exponential a pair,
// 268 M; under 6 MB moved (~2 us at 3.35 TB/s).
// - On the float32 FMA pipe (the design before this one, one thread a
//   query row): 25.8 GFLOP at 67 TFLOP/s, 0.385 ms.
// - On the tensor cores in 3xTF32 (this design): 3 x 25.8 GFLOP at
//   495 TFLOP/s dense TF32, 0.156 ms; the exponentials 0.069 ms at 16 a
//   clock an SM and 1.83 GHz, the clock the 495 TFLOP/s assumes. The bound
//   is 0.156 ms.
//
// Design (the forward kernel's, flash_attn_fwd.cu, plus one product;
// helpers and operand layouts in flash_mma.cuh):
// - One block of two warpgroups (8 warps) for each (128 query rows, batch x
//   head); a warpgroup owns 64 rows, a warp 16. Its q fragments (scaled by
//   scale * log2(e), so S comes out in base-2 units) and dO fragments are
//   split into TF32 big and small parts once and stay in registers as
//   wgmma's A, with the rows' lse * log2(e), di and the dQ accumulator.
// - K and V tiles of 64 keys are copied by cp.async into a two-stage raw
//   ring in shared memory while the previous tile is computed. Once a tile
//   lands, the block splits it, each value once, into big and small parts in
//   the core-matrix layouts wgmma reads as B: K over d (for S), V over d
//   (for dP) and K over keys (for dQ: transposed, since TF32 wgmma takes
//   K-major B only).
// - Per tile and warpgroup, every product in 3xTF32 (float32-grade), where
//   lse and di are known, so no online softmax, in two halves of 32 keys:
//   S = (c q) K^T and dP = dO V^T (m64n32k8, 12 wgmma, one commit group),
//   P = exp2(S - lse * log2(e)), dS = P (dP - di), dQ += dS K (m64n16k8, 12
//   wgmma). dS goes from the D fragment to the A fragment in registers, as
//   P does in the forward. Halves keep S, dP and dS's parts of 32 keys live
//   at a time, not 64: 106 registers a thread, so two blocks fit an SM.
//   With all 64 keys at once the kernel took 149 registers, one block an
//   SM, and ran 14% slower on the card; held to 128 registers it spilled
//   (PERF.md).
// - A tile's dS K is summed in fresh accumulators and added to dQ in
//   float32 (the tensor cores' sums round toward zero; see
//   flash_attn_fwd.cu).
// - Ragged L: key tiles past L are zero-filled by cp.async and the scores
//   of keys past L (in the last tile only) are -inf, so their p and dS are
//   0; rows past L read q, dO, lse and di as 0, are computed and not stored.
// Every sum is one warpgroup's, in a fixed order: no atomics, so the
// gradient is deterministic.

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
constexpr int kSub = 32;               // keys of one pass over S, dP and dS
constexpr int kTile = kTileK * kD;     // floats of a 64 x 16 tile
constexpr int kRaw = 2 * kTile;        // floats of one raw stage: K, then V
// shared memory (static, under 48 KB): two raw stages, then K big and small
// over d, V big and small over d, K big and small over keys
constexpr int kKdb = 2 * kRaw, kKds = kKdb + kTile;
constexpr int kVdb = kKds + kTile, kVds = kVdb + kTile;
constexpr int kKrb = kVds + kTile, kKrs = kKrb + kTile;
constexpr int kSmemBytes = (kKrs + kTile) * 4;

// Split a landed raw K/V tile into big and small parts, each value once for
// the block: K as B over d and over keys, V as B over d.
__device__ __forceinline__ void split_tile(const float* raw, float* smem) {
  uint32_t* su = reinterpret_cast<uint32_t*>(smem);
  for (int i = threadIdx.x; i < 2 * kTileK * 4; i += kThreads) {
    const bool is_v = i >= kTileK * 4;
    const int r = (i >> 2) & (kTileK - 1), c = (i & 3) * 4;
    const float4 x = *reinterpret_cast<const float4*>(raw + (is_v ? kTile : 0) + r * kD + c);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t b, sm;
      split(xs[e], b, sm);
      const int ad = at_over_d(r, c + e);
      su[(is_v ? kVdb : kKdb) + ad] = b;
      su[(is_v ? kVds : kKds) + ad] = sm;
      if (!is_v) {
        const int ar = at_over_rows(r, c + e);
        su[kKrb + ar] = b;
        su[kKrs + ar] = sm;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    float* __restrict__ dq, int L, float scale) {
  __shared__ __align__(16) float smem[kSmemBytes / 4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t head = (size_t)blockIdx.y * L;  // first row of this (b, h)
  const float* kg = k + head * kD;
  const float* vg = v + head * kD;
  const int row = blockIdx.x * kRowsQ + warp * 16 + g;  // and row + 8

  // q * scale * log2(e) and dO as A over d: k-step kk holds d = 4t + 2kk in
  // slot t, 4t + 2kk + 1 in t + 4; each row's lse * log2(e) and di
  const float c = scale * kLog2e;
  uint32_t q_big[2][4], q_small[2][4], do_big[2][4], do_small[2][4];
  float lse2[2], dir[2];
  {
    float4 qx[2], dx[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = row + 8 * r < L;
      const size_t at = (head + row + 8 * r) * kD + 4 * t;
      qx[r] = in ? *reinterpret_cast<const float4*>(q + at) : make_float4(0.f, 0.f, 0.f, 0.f);
      dx[r] = in ? *reinterpret_cast<const float4*>(dout + at) : make_float4(0.f, 0.f, 0.f, 0.f);
      qx[r] = make_float4(qx[r].x * c, qx[r].y * c, qx[r].z * c, qx[r].w * c);
      lse2[r] = in ? lse[head + row + 8 * r] * kLog2e : 0.f;
      dir[r] = in ? di[head + row + 8 * r] : 0.f;
    }
    split_a(qx[0].x, qx[1].x, qx[0].y, qx[1].y, q_big[0], q_small[0]);
    split_a(qx[0].z, qx[1].z, qx[0].w, qx[1].w, q_big[1], q_small[1]);
    split_a(dx[0].x, dx[1].x, dx[0].y, dx[1].y, do_big[0], do_small[0]);
    split_a(dx[0].z, dx[1].z, dx[0].w, dx[1].w, do_big[1], do_small[1]);
  }

  float acc[8];  // dQ: acc[4 ng + e] is row g + 8 (e >> 1), d = 4t + 2 (e & 1) + ng
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;

  const int n_tiles = (L + kTileK - 1) / kTileK;
  stage_rows<kTileK>(smem, kg, 0, L);
  stage_rows<kTileK>(smem + kTile, vg, 0, L);
  cp_async_commit();

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {  // the next raw tile into the other stage
      float* next = smem + ((it + 1) & 1) * kRaw;
      stage_rows<kTileK>(next, kg, (it + 1) * kTileK, L);
      stage_rows<kTileK>(next + kTile, vg, (it + 1) * kTileK, L);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();     // for every thread, and every warpgroup is done with the last tile
    split_tile(smem + (it & 1) * kRaw, smem);
    fence_async_smem();
    __syncthreads();
    const int nk = min(kTileK, L - it * kTileK);

    // this tile's dQ products, summed in fresh accumulators
    float dq_t[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) dq_t[i] = 0.f;
#pragma unroll
    for (int h = 0; h < kTileK / kSub; ++h) {
      // S = (c q) K^T and dP = dO V^T over keys h * kSub + (0 .. kSub - 1);
      // [4j + e] is row g + 8 (e >> 1), key h * kSub + 8j + 2t + (e & 1)
      float s[kSub / 2], dp[kSub / 2];
#pragma unroll
      for (int i = 0; i < kSub / 2; ++i) s[i] = dp[i] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)  // the half's n-groups start kSub * 8 floats in
        wgmma3(s, q_big[kk], q_small[kk], smem + kKdb + kk * 512 + h * kSub * 8,
               smem + kKds + kk * 512 + h * kSub * 8);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma3(dp, do_big[kk], do_small[kk], smem + kVdb + kk * 512 + h * kSub * 8,
               smem + kVds + kk * 512 + h * kSub * 8);
      wg_commit();
      wg_wait();
      fence_regs(s);
      fence_regs(dp);

      // keys past L (in the last tile only) score -inf, so p = 0
      if (nk < kTileK) {
#pragma unroll
        for (int i = 0; i < kSub / 2; ++i)
          if (h * kSub + 8 * (i >> 2) + 2 * t + (i & 1) >= nk) s[i] = -INFINITY;
      }
      // dS = P (dP - di), split as A over keys: k-step j takes keys
      // 8j + 2t (slot t) and 8j + 2t + 1 (t + 4), i.e. [4j], [4j + 2] and
      // [4j + 1], [4j + 3]
      uint32_t ab[kSub / 8][4], as[kSub / 8][4];
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[e] = ex2(s[4 * j + e] - lse2[e >> 1]) * (dp[4 * j + e] - dir[e >> 1]);
        split_a(ds[0], ds[2], ds[1], ds[3], ab[j], as[j]);
      }

      // dQ += dS K
      fence_regs(dq_t);
      wg_fence();
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j)
        wgmma3(dq_t, ab[j], as[j], smem + kKrb + (h * kSub / 8 + j) * 128,
               smem + kKrs + (h * kSub / 8 + j) * 128);
      wg_commit();
      wg_wait();
      fence_regs(dq_t);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += dq_t[i];
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    if (rr < L)
      *reinterpret_cast<float4*>(dq + (head + rr) * kD + 4 * t) = make_float4(
          acc[2 * r] * scale, acc[4 + 2 * r] * scale, acc[2 * r + 1] * scale,
          acc[5 + 2 * r] * scale);
  }
}

}  // namespace

// All arrays float32, contiguous: q, k, v, dout, dq (BH, L, 16); lse, di
// (BH, L). BH = batch x heads. Returns cudaGetLastError() after the launch.
extern "C" int flash_attn_bwd_dq_launch(const float* q, const float* k,
                                        const float* v, const float* dout,
                                        const float* lse, const float* di,
                                        float* dq, int BH, int L, float scale,
                                        cudaStream_t stream) {
  if (BH > 0 && L > 0) {
    const dim3 grid((L + kRowsQ - 1) / kRowsQ, BH);
    flash_bwd_dq_kernel<<<grid, kThreads, 0, stream>>>(q, k, v, dout, lse, di, dq, L,
                                                      scale);
  }
  return (int)cudaGetLastError();
}
