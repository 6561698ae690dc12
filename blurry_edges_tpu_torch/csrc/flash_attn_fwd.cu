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
// Bound on an H100: float32 operations. A (query, key) pair costs 2*D for
// q.k and 2*D for p*v (a multiply-add counts 2): 4*L^2*D a head. At the
// global trainer's chunk shape (B = 2, H = 8, L = 4,096, D = 16) that is
// 17.2 GFLOP, 0.26 ms at 67 TFLOP/s, against 4 MB of q, k, v, o and lse
// (~1.3 us at 3.35 TB/s). Float32 FMA, not TF32 or bf16 tensor cores: the
// reference runs float32 operands.
//
// Design: one block for each (tile of kBlockQ query rows, batch x head);
// each thread owns one query row, so q, the running max, the running sum and
// the 16-wide output accumulator stay in registers. K and V tiles of kTileK
// keys (8 KB each) are staged in shared memory; every lane of a warp reads
// the same key at the same time, a broadcast. Keys are scored kChunk at a
// time (16 independent dot products), then the running max moves once a
// chunk. Nothing carries over between blocks; no atomics. A ragged last
// tile is zero-filled and its scores set to -inf; rows past L are computed
// and not stored.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kD = 16;        // head dim, the only one the wrapper passes
constexpr int kBlockQ = 64;   // query rows (threads) a block
constexpr int kTileK = 128;   // keys a shared-memory tile
constexpr int kChunk = 16;    // keys scored together in registers
constexpr int kVec = kD / 4;  // float4 a row

__device__ __forceinline__ float dot16(const float* a, const float4* b) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; i += 2) {
    const float4 x = b[i], y = b[i + 1];
    s0 = fmaf(a[4 * i + 0], x.x, s0);
    s0 = fmaf(a[4 * i + 1], x.y, s0);
    s0 = fmaf(a[4 * i + 2], x.z, s0);
    s0 = fmaf(a[4 * i + 3], x.w, s0);
    s1 = fmaf(a[4 * i + 4], y.x, s1);
    s1 = fmaf(a[4 * i + 5], y.y, s1);
    s1 = fmaf(a[4 * i + 6], y.z, s1);
    s1 = fmaf(a[4 * i + 7], y.w, s1);
  }
  return s0 + s1;
}

__global__ void __launch_bounds__(kBlockQ)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int L, float scale) {
  __shared__ float4 ks[kTileK * kVec];
  __shared__ float4 vs[kTileK * kVec];

  const size_t head = (size_t)blockIdx.y * L;  // first row of this (b, h)
  const int row = blockIdx.x * kBlockQ + threadIdx.x;
  const bool valid = row < L;

  float qr[kD];
  if (valid) {
    const float4* src = reinterpret_cast<const float4*>(q + (head + row) * kD);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float4 t = src[i];
      qr[4 * i] = t.x; qr[4 * i + 1] = t.y; qr[4 * i + 2] = t.z; qr[4 * i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kD; ++i) qr[i] = 0.f;
  }

  float m = -INFINITY, l = 0.f, acc[kD];
#pragma unroll
  for (int i = 0; i < kD; ++i) acc[i] = 0.f;

  const float4* kg = reinterpret_cast<const float4*>(k + head * kD);
  const float4* vg = reinterpret_cast<const float4*>(v + head * kD);
  for (int t0 = 0; t0 < L; t0 += kTileK) {
    const int nk = min(kTileK, L - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < kTileK * kVec; i += kBlockQ) {
      const bool in = i < nk * kVec;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      ks[i] = in ? kg[(size_t)t0 * kVec + i] : zero;
      vs[i] = in ? vg[(size_t)t0 * kVec + i] : zero;
    }
    __syncthreads();

    for (int c0 = 0; c0 < nk; c0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float d = dot16(qr, ks + (c0 + j) * kVec) * scale;
        s[j] = (c0 + j < nk) ? d : -INFINITY;
        cmax = fmaxf(cmax, s[j]);
      }
      const float mn = fmaxf(m, cmax);  // finite: key c0 is in range
      const float corr = expf(m - mn);  // 0 on the first chunk (m = -inf)
      l *= corr;
#pragma unroll
      for (int i = 0; i < kD; ++i) acc[i] *= corr;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = expf(s[j] - mn);
        l += p;
        const float4* vr = vs + (c0 + j) * kVec;
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float4 t = vr[i];
          acc[4 * i + 0] = fmaf(p, t.x, acc[4 * i + 0]);
          acc[4 * i + 1] = fmaf(p, t.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(p, t.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(p, t.w, acc[4 * i + 3]);
        }
      }
      m = mn;
    }
  }

  if (valid) {
    const float inv = 1.f / l;
    float4* dst = reinterpret_cast<float4*>(o + (head + row) * kD);
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      dst[i] = make_float4(acc[4 * i] * inv, acc[4 * i + 1] * inv,
                           acc[4 * i + 2] * inv, acc[4 * i + 3] * inv);
    lse[head + row] = m + logf(l);
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
    const dim3 grid((L + kBlockQ - 1) / kBlockQ, BH);
    flash_fwd_kernel<<<grid, kBlockQ, 0, stream>>>(q, k, v, o, lse, L, scale);
  }
  return (int)cudaGetLastError();
}
