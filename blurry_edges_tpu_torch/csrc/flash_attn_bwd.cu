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
// Bound on an H100: float32 operations. A (query, key) pair costs 6*D (q.k,
// dO.v, dS*k), a multiply-add counting 2. At the global trainer's chunk
// shape (B = 2, H = 8, L = 4,096, D = 16): 25.8 GFLOP, 0.39 ms at
// 67 TFLOP/s; it moves under 6 MB (~2 us at 3.35 TB/s). Float32 FMA, not
// TF32 or bf16 tensor cores.
//
// Design: one block for each (tile of kBlock query rows, batch x head); a
// thread owns one query row with q, dO, lse, di and its dQ accumulator, and
// walks tiles of k and v staged in shared memory (all lanes read the same
// key: a broadcast). Every sum is a thread's own, in a fixed order: no
// atomics, so the gradient is deterministic. Rows past L are zero-filled in
// shared memory and skipped by the loop bounds.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kD = 16;       // head dim
constexpr int kBlock = 64;   // rows (threads) a block
constexpr int kTile = 128;   // rows a shared-memory tile
constexpr int kVec = kD / 4;

__device__ __forceinline__ void load_row(const float* src, float* dst) {
  const float4* s = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const float4 t = s[i];
    dst[4 * i] = t.x; dst[4 * i + 1] = t.y; dst[4 * i + 2] = t.z; dst[4 * i + 3] = t.w;
  }
}

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

__device__ __forceinline__ void axpy16(float a, const float4* x, float* y) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const float4 t = x[i];
    y[4 * i + 0] = fmaf(a, t.x, y[4 * i + 0]);
    y[4 * i + 1] = fmaf(a, t.y, y[4 * i + 1]);
    y[4 * i + 2] = fmaf(a, t.z, y[4 * i + 2]);
    y[4 * i + 3] = fmaf(a, t.w, y[4 * i + 3]);
  }
}

__device__ __forceinline__ void store_row(float* dst, const float* src, float mul) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    d[i] = make_float4(src[4 * i] * mul, src[4 * i + 1] * mul,
                       src[4 * i + 2] * mul, src[4 * i + 3] * mul);
}

// Stage rows [t0, t0 + n) of two (L, 16) arrays into shared memory,
// zero-filling the rest of the tile.
__device__ __forceinline__ void stage_pair(const float* a, const float* b,
                                           float4* as, float4* bs, int t0, int n) {
  const float4* ag = reinterpret_cast<const float4*>(a) + (size_t)t0 * kVec;
  const float4* bg = reinterpret_cast<const float4*>(b) + (size_t)t0 * kVec;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < kTile * kVec; i += blockDim.x) {
    const bool in = i < n * kVec;
    as[i] = in ? ag[i] : zero;
    bs[i] = in ? bg[i] : zero;
  }
}

__global__ void __launch_bounds__(kBlock)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    float* __restrict__ dq, int L, float scale) {
  __shared__ float4 ks[kTile * kVec];
  __shared__ float4 vs[kTile * kVec];

  const size_t head = (size_t)blockIdx.y * L;
  const int row = blockIdx.x * kBlock + threadIdx.x;  // this thread's query
  const bool valid = row < L;

  float qr[kD], dor[kD], dqr[kD];
  float lse_r = 0.f, di_r = 0.f;
#pragma unroll
  for (int i = 0; i < kD; ++i) { qr[i] = dor[i] = dqr[i] = 0.f; }
  if (valid) {
    load_row(q + (head + row) * kD, qr);
    load_row(dout + (head + row) * kD, dor);
    lse_r = lse[head + row];
    di_r = di[head + row];
  }

  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int nk = min(kTile, L - t0);
    __syncthreads();
    stage_pair(k + head * kD, v + head * kD, ks, vs, t0, nk);
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < nk; ++j) {
      const float4* kj = ks + j * kVec;
      const float p = expf(dot16(qr, kj) * scale - lse_r);
      const float dp = dot16(dor, vs + j * kVec);
      axpy16(p * (dp - di_r), kj, dqr);
    }
  }

  if (valid) store_row(dq + (head + row) * kD, dqr, scale);
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
    const dim3 grid((L + kBlock - 1) / kBlock, BH);
    flash_bwd_dq_kernel<<<grid, kBlock, 0, stream>>>(q, k, v, dout, lse, di,
                                                     dq, L, scale);
  }
  return (int)cudaGetLastError();
}
