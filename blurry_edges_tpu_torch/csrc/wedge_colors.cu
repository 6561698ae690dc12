// Per-patch wedge color solve: raw local-stage parameters and the noisy
// patch -> the 3 wedge colors by ridge regression.
//
// Replaces the TPU kernel blurry_edges_tpu/ops/wedge_pallas.py::
// wedge_colors_pallas (_wedge_colors_kernel). Per patch: angles wrapped
// mod 2pi, the four edge distance fields, the signed wedge distances,
// eta = 10^(2 erf(c) - 2), the memberships u0, u1, u2, six Gram sums plus
// lambda, nine A^T y sums and a Cayley-Hamilton 3x3 inverse -> colors.
//
// Bounds on an H100. Bytes: at the serving shapes (8,192 patches a pair)
// it reads 8,192 x (10 + 1,323) float32 = 44 MB and writes 0.3 MB, ~13 us
// at 3.35 TB/s. Float32 operations: ~8 us at 67 TFLOP/s, 3.6 M pixels at
// ~150 a pixel (a multiply-add counts 2), counted from the per-pixel code
// below: coordinates and the four edge distances with their
// back-extension and the wedge signs ~74, two erff memberships ~46, six
// Gram and nine A^T y multiply-adds 30 (chip_smoke.py takes its bound from
// this count). But what binds on the card is instructions issued: the
// pixel loop compiles to 185 SASS instructions (the selects and fix-ups
// of the square roots and of erff's two polynomial ranges count too), 21 M
// warp instructions at one pair, ~23 us at one a clock a scheduler; with
// no pixels copied in at all the kernel still takes ~0.032 ms (PERF.md).
//
// Design: one warp a patch, 4 warps a block, at most 64 registers a thread
// so that 8 blocks (32 warps) fit an SM.
// - At entry the warp queues its patch's 5,292 contiguous bytes of pixels
//   into its shared memory by cp.async (16-byte chunks for the body, 4-byte
//   copies at the ends of the three in four patches that do not start on
//   16 bytes), and works out the trig of the geometry and both blur levels
//   while they arrive: the patch's whole load in flight at once, where
//   loads inside the pixel loop kept one round trip of 384 bytes a warp in
//   flight.
// - The pixel loop then reads shared memory: each lane takes every 32nd
//   pixel, and the pixel's coordinates come from a division by R known at
//   compile time (the serving R = 21; any other R runs the same kernel
//   with R as an argument). Each wedge's distance is the root of the
//   smaller of its two edges' squared distances (wedge_dists_sq): two
//   square roots a pixel where the earlier design took four.
// - The 15 sums reduce across the warp with __shfl_xor_sync; the inverse
//   is in double (wedge_common.cuh); erff is CUDA's own. Nothing is
//   written but the 9 colors.
// - What was tried and did not run faster on the card (PERF.md): the copy
//   in two commit groups, a lane's 42 values prefetched into registers, 8
//   warps a block, 40 warps an SM (spills), two pixels a lane at a time
//   (also at 24 warps an SM), the pixel's row and column stepped instead
//   of divided.

#include "async_copy.cuh"
#include "wedge_common.cuh"

namespace {

using namespace async_copy;

constexpr int kWarps = 4;      // warps a block, a patch each
constexpr int kMinBlocks = 8;  // blocks an SM: 64 registers a thread
constexpr int kServingR = 21;  // the patch size compiled in

// floats of shared memory a warp: its patch's pixels, with room to align
// them as their source is
__host__ __device__ constexpr int warp_floats(int N) { return round4(3 * N + 3); }

size_t smem_bytes(int R) { return (size_t)kWarps * warp_floats(R * R) * 4; }

// the Gram and A^T y terms of the pixel at (x, y), whose three values are
// v[0 .. 3)
__device__ __forceinline__ void add_pixel(const wedge::Geometry& g, float x, float y, float w,
                                          float k1, float k2, const float* v, float gram[6],
                                          float aty[3][3]) {
  float d1, d2, u[3];
  wedge::wedge_dists_sq(g, x, y, w, d1, d2);
  wedge::memberships(d1, d2, k1, k2, u);
  wedge::add_gram(u, gram);
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int k = 0; k < 3; ++k) aty[k][c] += u[k] * v[c];
}

// kR > 0: the patch size, fixed at compile time; kR = 0: R_arg
template <int kR>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
wedge_colors_kernel(const float* __restrict__ params, const float* __restrict__ pixels,
                    float* __restrict__ colors, int P, int R_arg, float w,
                    float lambda_ridge) {
  extern __shared__ __align__(16) float smem[];
  const int R = kR > 0 ? kR : R_arg;
  const int N = R * R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = blockIdx.x * kWarps + warp;
  if (p >= P) return;  // the whole warp leaves together

  // the patch's pixels, copied in while the geometry is worked out; pixel
  // n's values at px[3n .. 3n + 3)
  const float* src = pixels + (size_t)p * N * 3;
  float* buf = smem + (size_t)warp * warp_floats(N);
  stage_range(buf, src, 3 * N, lane);
  cp_async_commit();
  const float* px = buf + misalign(src);

  float q[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) q[i] = __ldg(params + (size_t)p * 10 + i);
  const wedge::Geometry g = wedge::make_geometry(q, true);
  const float k1 = wedge::kInvSqrt2 / wedge::coef_to_eta(q[8]);
  const float k2 = wedge::kInvSqrt2 / wedge::coef_to_eta(q[9]);
  const float step = 2.f / (float)(R - 1);

  float gram[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float aty[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  cp_async_wait<0>();
  __syncwarp();
  for (int n = lane; n < N; n += 32) {
    float x, y;
    wedge::pixel_xy(n, R, step, x, y);
    add_pixel(g, x, y, w, k1, k2, px + 3 * n, gram, aty);
  }

#pragma unroll
  for (int i = 0; i < 6; ++i) gram[i] = wedge::warp_sum(gram[i]);
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int c = 0; c < 3; ++c) aty[k][c] = wedge::warp_sum(aty[k][c]);

  float m[3][3];
  wedge::ridge_inverse(gram, lambda_ridge, m);
  if (lane == 0) {
    float* out = colors + (size_t)p * 9;
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        out[k * 3 + c] = m[k][0] * aty[0][c] + m[k][1] * aty[1][c] + m[k][2] * aty[2][c];
  }
}

template <int kR>
void launch(const float* params, const float* pixels, float* colors, int P, int R, float w,
            float lambda_ridge, cudaStream_t stream) {
  const size_t smem = smem_bytes(R);
  if (smem > 48 * 1024)  // past the default a block may take
    cudaFuncSetAttribute(wedge_colors_kernel<kR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  wedge_colors_kernel<kR><<<(P + kWarps - 1) / kWarps, kWarps * 32, smem, stream>>>(
      params, pixels, colors, P, R, w, lambda_ridge);
}

}  // namespace

// params (P, 10) raw local-stage outputs, pixels (P, R, R, 3) -> colors
// (P, 3 wedges, 3 channels); all float32, contiguous, on the device.
// Returns cudaGetLastError() after the launch.
extern "C" int wedge_colors_launch(const float* params, const float* pixels,
                                   float* colors, int P, int R, float w,
                                   float lambda_ridge, void* stream) {
  if (P > 0) {
    if (R == kServingR)
      launch<kServingR>(params, pixels, colors, P, R, w, lambda_ridge, (cudaStream_t)stream);
    else
      launch<0>(params, pixels, colors, P, R, w, lambda_ridge, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

// Dynamic shared memory a block of the kernel takes at patch size R.
extern "C" int wedge_colors_smem_bytes(int R) { return (int)smem_bytes(R); }
