// Per-patch wedge color solve: raw local-stage parameters and the noisy
// patch -> the 3 wedge colors by ridge regression.
//
// Replaces the TPU kernel blurry_edges_tpu/ops/wedge_pallas.py::
// wedge_colors_pallas (_wedge_colors_kernel). Per patch: angles wrapped
// mod 2pi, the four edge distance fields, the signed wedge distances,
// eta = 10^(2 erf(c) - 2), the memberships u0, u1, u2, six Gram sums plus
// lambda, nine A^T y sums and a Cayley-Hamilton 3x3 inverse -> colors.
//
// Bound on an H100: memory. At the serving shapes (8,192 patches a pair)
// it reads 8,192 x (10 + 1,323) float32 = 44 MB and writes 0.3 MB, ~13 us
// at 3.35 TB/s; the arithmetic is ~8 us at 67 TFLOP/s: 3.6 M pixels at
// ~150 float32 operations a pixel (a multiply-add counts 2), counted from
// the per-pixel code below: coordinates and the four edge distances with
// their back-extension and the wedge signs ~74, two erff memberships ~46,
// six Gram and nine A^T y multiply-adds 30. chip_smoke.py takes its bound
// from this count.
//
// Design: one warp per patch; each lane takes every 32nd pixel, so a warp's
// loads of a patch are contiguous. The sums stay in registers and reduce
// across the warp with __shfl_xor_sync; the trig is done once per patch;
// erff is CUDA's own. Nothing is written but the 9 colors.

#include "wedge_common.cuh"

namespace {

__global__ void __launch_bounds__(wedge::kWarpsPerBlock * 32)
wedge_colors_kernel(const float* __restrict__ params,
                    const float* __restrict__ pixels,
                    float* __restrict__ colors, int P, int R, float w,
                    float lambda_ridge) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * wedge::kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= P) return;  // the whole warp leaves together

  float q[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) q[i] = __ldg(params + (size_t)p * 10 + i);
  const wedge::Geometry g = wedge::make_geometry(q, true);
  const float k1 = wedge::kInvSqrt2 / wedge::coef_to_eta(q[8]);
  const float k2 = wedge::kInvSqrt2 / wedge::coef_to_eta(q[9]);

  const int N = R * R;
  const float step = 2.f / (float)(R - 1);
  const float* px = pixels + (size_t)p * N * 3;

  float gram[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float aty[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  for (int n = lane; n < N; n += 32) {
    float x, y, d1, d2, u[3];
    wedge::pixel_xy(n, R, step, x, y);
    wedge::wedge_dists(g, x, y, w, d1, d2);
    wedge::memberships(d1, d2, k1, k2, u);
    wedge::add_gram(u, gram);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = __ldg(px + n * 3 + c);
#pragma unroll
      for (int k = 0; k < 3; ++k) aty[k][c] += u[k] * v;
    }
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

}  // namespace

// params (P, 10) raw local-stage outputs, pixels (P, R, R, 3) -> colors
// (P, 3 wedges, 3 channels); all float32, contiguous, on the device.
// Returns cudaGetLastError() after the launch.
extern "C" int wedge_colors_launch(const float* params, const float* pixels,
                                   float* colors, int P, int R, float w,
                                   float lambda_ridge, void* stream) {
  if (P > 0) {
    const int blocks = (P + wedge::kWarpsPerBlock - 1) / wedge::kWarpsPerBlock;
    wedge_colors_kernel<<<blocks, wedge::kWarpsPerBlock * 32, 0,
                          (cudaStream_t)stream>>>(params, pixels, colors, P, R,
                                                  w, lambda_ridge);
  }
  return (int)cudaGetLastError();
}
