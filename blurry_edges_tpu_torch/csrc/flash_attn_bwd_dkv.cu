// Flash attention backward, dK and dV, from q, k, v, the output gradient dO,
// the forward's lse and di = rowsum(o * dO), recomputing the probabilities
// tile by tile instead of reading them.
//
// Replaces the TPU kernel of the library flash attention that
// blurry_edges_tpu/models/global_stage.py::flash_attention_fn calls:
// jax/experimental/pallas/ops/tpu/flash_attention.py::_flash_attention_bwd_dkv
// (its pallas_call, body _flash_attention_dkv_kernel). As there, di is
// computed outside the kernel. dQ is the other kernel, in flash_attn_bwd_dq.cu.
//
// With s = scale * q.k, p = exp(s - lse), dP = dO.v, dS = p * (dP - di):
//   dV = sum over queries of p * dO,   dK = scale * sum over queries of dS * q.
//
// Bound on an H100 at the global trainer's chunk shape (B = 2, H = 8,
// L = 4,096, D = 16). The function: 8*D a (key, query) pair (q.k, p*dO,
// dO.v, dS*q; a multiply-add counts 2), 34.4 GFLOP; one exponential a pair,
// 268 M; under 6 MB moved (2 us at 3.35 TB/s).
// - On the float32 FMA pipe (the design before this one): 34.4 GFLOP at
//   67 TFLOP/s, 0.513 ms.
// - On the tensor cores in 3xTF32 (this design): 3 x 34.4 GFLOP at
//   495 TFLOP/s dense TF32, 0.208 ms; the exponentials 0.069 ms at 16 a clock
//   an SM and 1.83 GHz, the clock the 495 TFLOP/s assumes. The bound is
//   0.208 ms.
//
// Design (FlashAttention-2's backward, keys outer, on wgmma in 3xTF32;
// helpers and operand layouts in flash_mma.cuh):
// - One block of two warpgroups (8 warps) for each (128 keys, batch x head);
//   a warpgroup owns 64 keys, a warp 16. Its k (scaled by scale * log2(e))
//   and v fragments are split into TF32 big and small parts once and stay in
//   registers as wgmma's A, with its dK and dV accumulators.
// - The block walks query tiles of 64 rows of q, dO, lse and di: cp.async
//   copies the next raw tile into shared memory while the current one is
//   computed. Once a tile lands, the block splits q and dO, each value once,
//   into big and small parts in the core-matrix layouts wgmma reads as B:
//   each twice, as B over d (for S^T and dP^T) and as B over queries (for dK
//   and dV: transposed, since TF32 wgmma takes K-major B only).
// - Per tile and warpgroup, every product in 3xTF32 (float32-grade):
//   S^T = (c K) Q^T (m64n64k8), P^T = exp2(S^T - lse * log2(e)),
//   dV += P^T dO (m64n16k8), dP^T = V dO^T (m64n64k8, issued while the dV
//   products run), dS^T = P^T (dP^T - di), dK += dS^T Q (m64n16k8). P^T and
//   dS^T go from D fragments to A fragments in registers; P^T is kept only
//   as its big and small parts (their sum is P^T to 2^-22).
// - A tile's dK and dV are summed in fresh accumulators and added to the
//   totals in float32 (the tensor cores' sums round toward zero; see
//   flash_attn_fwd.cu).
// - Why wgmma and not mma.sync.m16n8k8 (this kernel's first design): wgmma
//   is the only way to the card's full TF32 rate, and the block splits the
//   shared q/dO tile once for all its warps, where mma.sync's fragments had
//   every warp split the whole tile itself; on the card the mma.sync design
//   was the slower (PERF.md).
// - Ragged L: rows past L are zero-filled (q, dO, lse and di), so their p is
//   1 but their dO and q are 0 and they add nothing; key rows past L are
//   computed and not stored.
// Every sum is one warpgroup's, in a fixed order: no atomics, so the
// gradients are deterministic.

#include <cuda_runtime.h>
#include <math.h>

#include "flash_mma.cuh"

namespace {

using namespace flash_mma;

constexpr int kD = 16;  // head dim
constexpr int kWG = 2;        // warpgroups a block
constexpr int kThreads = 128 * kWG;
constexpr int kRowsK = 64 * kWG;     // keys a block
constexpr int kTileQ = 64;           // queries a tile
constexpr int kTile = kTileQ * kD;   // floats of a 64 x 16 tile
// shared memory (static, under 48 KB): the raw tile (q, dO, lse, di as in device memory),
// then q and dO big and small as B over d and as B over queries, then
// lse * log2(e) and di
constexpr int kRawDo = kTile, kRawLse = 2 * kTile, kRawDi = kRawLse + kTileQ;
constexpr int kQdb = kRawDi + kTileQ, kQds = kQdb + kTile, kQrb = kQds + kTile,
              kQrs = kQrb + kTile;
constexpr int kDdb = kQrs + kTile, kDds = kDdb + kTile, kDrb = kDds + kTile,
              kDrs = kDrb + kTile;
constexpr int kLse2 = kDrs + kTile, kDi = kLse2 + kTileQ;
constexpr int kSmemBytes = (kDi + kTileQ) * 4;

// Copy rows [t0, t0 + 64) of q, dO, lse and di into the raw tile; rows past
// L become zeros.
__device__ __forceinline__ void stage_tile(float* smem, const float* qg, const float* dog,
                                           const float* lg, const float* dg, int t0, int L) {
  stage_rows<kTileQ>(smem, qg, t0, L);
  stage_rows<kTileQ>(smem + kRawDo, dog, t0, L);
  for (int i = threadIdx.x; i < 2 * kTileQ; i += kThreads) {  // lse, then di
    const int r = i % kTileQ;
    const bool in = t0 + r < L;
    cp_async4(smem + kRawLse + i, (i < kTileQ ? lg : dg) + (in ? t0 + r : 0), in ? 4 : 0);
  }
}

// Split the raw tile's q and dO into big and small parts in both B layouts,
// and scale lse by log2(e).
__device__ __forceinline__ void split_tile(float* smem) {
  uint32_t* su = reinterpret_cast<uint32_t*>(smem);
  for (int i = threadIdx.x; i < 2 * kTileQ * 4; i += kThreads) {
    const bool is_do = i >= kTileQ * 4;
    const int r = (i >> 2) & (kTileQ - 1), c = (i & 3) * 4;
    const float4 x = *reinterpret_cast<const float4*>(smem + (is_do ? kRawDo : 0) + r * kD + c);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t b, sm;
      split(xs[e], b, sm);
      const int ad = at_over_d(r, c + e), ar = at_over_rows(r, c + e);
      su[(is_do ? kDdb : kQdb) + ad] = b;
      su[(is_do ? kDds : kQds) + ad] = sm;
      su[(is_do ? kDrb : kQrb) + ar] = b;
      su[(is_do ? kDrs : kQrs) + ar] = sm;
    }
  }
  for (int i = threadIdx.x; i < kTileQ; i += kThreads) {
    smem[kLse2 + i] = smem[kRawLse + i] * kLog2e;
    smem[kDi + i] = smem[kRawDi + i];
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     float* __restrict__ dk, float* __restrict__ dv, int L,
                     float scale) {
  __shared__ __align__(16) float smem[kSmemBytes / 4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t head = (size_t)blockIdx.y * L;
  const float* qg = q + head * kD;
  const float* dog = dout + head * kD;
  const int row = blockIdx.x * kRowsK + warp * 16 + g;  // this thread's keys: row, row + 8

  // k * scale * log2(e) and v as A over d: k-step kk holds d = 4t + 2kk in
  // slot t, 4t + 2kk + 1 in t + 4
  const float c = scale * kLog2e;
  uint32_t k_big[2][4], k_small[2][4], v_big[2][4], v_small[2][4];
  {
    float4 kx[2], vx[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = row + 8 * r < L;
      const size_t at = (head + row + 8 * r) * kD + 4 * t;
      kx[r] = in ? *reinterpret_cast<const float4*>(k + at) : make_float4(0.f, 0.f, 0.f, 0.f);
      vx[r] = in ? *reinterpret_cast<const float4*>(v + at) : make_float4(0.f, 0.f, 0.f, 0.f);
      kx[r] = make_float4(kx[r].x * c, kx[r].y * c, kx[r].z * c, kx[r].w * c);
    }
    split_a(kx[0].x, kx[1].x, kx[0].y, kx[1].y, k_big[0], k_small[0]);
    split_a(kx[0].z, kx[1].z, kx[0].w, kx[1].w, k_big[1], k_small[1]);
    split_a(vx[0].x, vx[1].x, vx[0].y, vx[1].y, v_big[0], v_small[0]);
    split_a(vx[0].z, vx[1].z, vx[0].w, vx[1].w, v_big[1], v_small[1]);
  }

  // dK, dV: [4 ng + e] is key row g + 8 (e >> 1), d = 4t + 2 (e & 1) + ng
  float dk_acc[8], dv_acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  const int n_tiles = (L + kTileQ - 1) / kTileQ;
  stage_tile(smem, qg, dog, lse + head, di + head, 0, L);
  cp_async_commit();

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();  // this tile's raw rows have landed
    __syncthreads();     // for every thread, and every warpgroup is done with the last tile
    split_tile(smem);
    fence_async_smem();
    __syncthreads();
    if (it + 1 < n_tiles) {  // the next raw tile, while this one is computed
      stage_tile(smem, qg, dog, lse + head, di + head, (it + 1) * kTileQ, L);
      cp_async_commit();
    }

    // S^T = (c K) Q^T; s[4j + e] is key row g + 8 (e >> 1), query 8j + 2t + (e & 1)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma3(s, k_big[kk], k_small[kk], smem + kQdb + kk * 512, smem + kQds + kk * 512);
    wg_commit();
    wg_wait();
    fence_regs(s);

    // P^T, split as A over queries: k-step j takes queries 8j + 2t (slot t)
    // and 8j + 2t + 1 (t + 4), i.e. s[4j], s[4j + 2] and s[4j + 1], s[4j + 3]
    uint32_t ab[8][4], as[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(smem + kLse2 + 8 * j + 2 * t);
      split_a(ex2(s[4 * j] - l2.x), ex2(s[4 * j + 2] - l2.x), ex2(s[4 * j + 1] - l2.y),
              ex2(s[4 * j + 3] - l2.y), ab[j], as[j]);
    }

    // dV += P^T dO into fresh sums; dP^T = V dO^T while they run
    float dv_t[8], dp[32];
#pragma unroll
    for (int i = 0; i < 8; ++i) dv_t[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = 0.f;
    fence_regs(dv_t);
    fence_regs(dp);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j)
      wgmma3(dv_t, ab[j], as[j], smem + kDrb + j * 128, smem + kDrs + j * 128);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma3(dp, v_big[kk], v_small[kk], smem + kDdb + kk * 512, smem + kDds + kk * 512);
    wg_commit();
    wg_wait();
    fence_regs(dv_t);
    fence_regs(dp);

    // dS^T = P^T (dP^T - di), split in place of P^T's parts
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dd = *reinterpret_cast<const float2*>(smem + kDi + 8 * j + 2 * t);
      float pr[4];  // P^T in the A order: s[4j], s[4j + 2], s[4j + 1], s[4j + 3]
#pragma unroll
      for (int e = 0; e < 4; ++e) pr[e] = __uint_as_float(ab[j][e]) + __uint_as_float(as[j][e]);
      split_a(pr[0] * (dp[4 * j] - dd.x), pr[1] * (dp[4 * j + 2] - dd.x),
              pr[2] * (dp[4 * j + 1] - dd.y), pr[3] * (dp[4 * j + 3] - dd.y), ab[j], as[j]);
    }

    // dK += dS^T Q into fresh sums
    float dk_t[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) dk_t[i] = 0.f;
    fence_regs(dk_t);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j)
      wgmma3(dk_t, ab[j], as[j], smem + kQrb + j * 128, smem + kQrs + j * 128);
    wg_commit();
    wg_wait();
    fence_regs(dk_t);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      dk_acc[i] += dk_t[i];
      dv_acc[i] += dv_t[i];
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    if (rr < L) {
      *reinterpret_cast<float4*>(dk + (head + rr) * kD + 4 * t) = make_float4(
          dk_acc[2 * r] * scale, dk_acc[4 + 2 * r] * scale, dk_acc[2 * r + 1] * scale,
          dk_acc[5 + 2 * r] * scale);
      *reinterpret_cast<float4*>(dv + (head + rr) * kD + 4 * t) = make_float4(
          dv_acc[2 * r], dv_acc[4 + 2 * r], dv_acc[2 * r + 1], dv_acc[5 + 2 * r]);
    }
  }
}

}  // namespace

// All arrays float32, contiguous: q, k, v, dout, dk, dv (BH, L, 16); lse, di
// (BH, L). BH = batch x heads. Returns cudaGetLastError() after the launch.
extern "C" int flash_attn_bwd_dkv_launch(const float* q, const float* k,
                                         const float* v, const float* dout,
                                         const float* lse, const float* di,
                                         float* dk, float* dv, int BH, int L,
                                         float scale, cudaStream_t stream) {
  if (BH > 0 && L > 0) {
    const dim3 grid((L + kRowsK - 1) / kRowsK, BH);
    flash_bwd_dkv_kernel<<<grid, kThreads, 0, stream>>>(q, k, v, dout, lse, di, dk, dv,
                                                       L, scale);
  }
  return (int)cudaGetLastError();
}
