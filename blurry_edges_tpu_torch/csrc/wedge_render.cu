// The full per-patch serving render: shared wedge geometry, the blur levels
// of both images and the pair's patches -> the pair renders (joint ridge
// color solve), the sharpened and refocused renders, the boundary map, the
// per-pixel DfD depth and the wedge mask.
//
// Replaces the TPU kernel blurry_edges_tpu/ops/wedge_pallas.py::
// wedge_render_pallas (_wedge_render_kernel), which stands in for
// blurry_edges_tpu/eval/pipeline.py::render_full.
//
// Bound on an H100: memory. At the serving shapes (4,096 patches a pair) it
// reads 4,096 x (12 + 2,646) float32 = 43.5 MB and writes
// 4,096 x 15 x 441 x 4 B = 108 MB, ~45 us at 3.35 TB/s; the arithmetic is
// ~11 us at 67 TFLOP/s: 1.8 M pixels (each of both images) at ~420 float32
// operations a pixel (a multiply-add counts 2), counted from the per-pixel
// code below: coordinates, distances and signs ~74 (as in wedge_colors.cu),
// four erff memberships (image A, image B, sharpened, refocused) 4 x 46,
// twelve Gram and nine A^T y multiply-adds 60, four renders 60, the mask
// ~24, the boundary map ~14 and the depth 2. This kernel's second pass
// recomputes the distances, the two images' memberships and the mask,
// ~610 operations a pixel as executed. chip_smoke.py takes its bound from
// the ~420 the function needs.
//
// Design: one warp per patch, each lane on every 32nd pixel. The colors are
// needed before anything can be rendered, so the kernel walks the pixels
// twice: pass 1 accumulates the Gram and A^T y sums of both images in
// registers (reduced with __shfl_xor_sync) and votes whether wedge 1 or 2
// owns any pixel (__any_sync), which picks the refocus blur; pass 2
// recomputes the distances and writes every output once, straight into the
// caller's layout. The DfD constants and the hard-mask switch are kernel
// arguments.

#include "wedge_common.cuh"

namespace {

struct RenderConsts {
  float w, lambda_ridge;
  int hard;                 // 1: wedge interiors (densify w); 0: boundary band
  float rho_prime;          // refocus optical power
  float delta2;             // boundary-map width squared
  float numerator, den_const, den_factor, den_root, intercept, s_cam;
};

// project (e1, e2) onto the valid DfD curve and invert to metric depth
__device__ __forceinline__ float etas2depth(float e1, float e2,
                                            const RenderConsts& k) {
  const float b = k.intercept;
  const float sw = 0.70710678118654752f, cw = 0.70710678118654752f;  // pi/4
  const float sm = 0.70710678118654757f, cm = -0.70710678118654746f;  // 3pi/4
  const float cond1 = -sw * e1 + cw * (e2 - b);
  const float cond2 = -sm * (e1 - b) + cm * e2;
  const float cond3 = -sw * (e1 - b) + cw * e2;
  float e11, e22;
  if (cond1 > 0.f) {
    e11 = (e1 + e2 - b) / 2.f;
    e22 = b + (e1 + e2 - b) / 2.f;
  } else if (cond2 > 0.f) {
    e11 = b + (e1 - e2 - b) / 2.f;
    e22 = (e2 - e1 + b) / 2.f;
  } else if (cond3 < 0.f) {
    e11 = b + (e1 + e2 - b) / 2.f;
    e22 = (e1 + e2 - b) / 2.f;
  } else {
    e11 = e1;
    e22 = e2;
  }
  return k.numerator / (k.den_factor * (e11 * e11 - e22 * e22) + k.den_const);
}

// wedge assignment: 0 background, 1 wedge 1, 2 wedge 2
__device__ __forceinline__ int wedge_mask(float d1, float d2,
                                          const RenderConsts& k) {
  if (k.hard) return d2 > 0.f ? 2 : (d1 > 0.f ? 1 : 0);
  // near-boundary bands; inside wedge 2 (d2 >= 0) wedge 2's band decides,
  // so an interior pixel away from its boundary is background
  const bool g1 = expf(-(d1 * d1) / k.delta2) > 0.5f;
  const bool g2 = expf(-(d2 * d2) / k.delta2) > 0.5f;
  if (g2 || d2 >= 0.f) return g2 ? 2 : 0;
  return g1 ? 1 : 0;
}

__device__ __forceinline__ void store_rgb(float* dst, const float u[3],
                                          const float col[3][3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
    dst[c] = u[0] * col[0][c] + u[1] * col[1][c] + u[2] * col[2][c];
}

__global__ void __launch_bounds__(wedge::kWarpsPerBlock * 32)
wedge_render_kernel(const float* __restrict__ xy, const float* __restrict__ etas,
                    const float* __restrict__ pix, float* __restrict__ patches,
                    float* __restrict__ shpd, float* __restrict__ refoc,
                    float* __restrict__ bndry, float* __restrict__ depth,
                    int* __restrict__ mask, int B, int L, int R, RenderConsts k) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * wedge::kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= B * L) return;  // the whole warp leaves together
  const int b = p / L, l = p - b * L;

  float q[8], e[4];
#pragma unroll
  for (int i = 0; i < 8; ++i) q[i] = __ldg(xy + (size_t)p * 8 + i);
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = __ldg(etas + (size_t)p * 4 + i);
  const wedge::Geometry g = wedge::make_geometry(q, false);
  const float kA1 = wedge::kInvSqrt2 / e[0], kA2 = wedge::kInvSqrt2 / e[1];
  const float kB1 = wedge::kInvSqrt2 / e[2], kB2 = wedge::kInvSqrt2 / e[3];

  const int N = R * R;
  const float step = 2.f / (float)(R - 1);
  // (B, 2, Hp, Wp, R, R, 3): image i of pair b, patch l
  const size_t offA = ((size_t)(b * 2) * L + l) * N * 3;
  const size_t offB = ((size_t)(b * 2 + 1) * L + l) * N * 3;

  // pass 1: joint Gram and A^T y sums over both images, wedge ownership
  float gram[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float aty[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  bool own1 = false, own2 = false;
  for (int n = lane; n < N; n += 32) {
    float x, y, d1, d2, uA[3], uB[3];
    wedge::pixel_xy(n, R, step, x, y);
    wedge::wedge_dists(g, x, y, k.w, d1, d2);
    wedge::memberships(d1, d2, kA1, kA2, uA);
    wedge::memberships(d1, d2, kB1, kB2, uB);
    wedge::add_gram(uA, gram);
    wedge::add_gram(uB, gram);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float vA = __ldg(pix + offA + n * 3 + c);
      const float vB = __ldg(pix + offB + n * 3 + c);
#pragma unroll
      for (int j = 0; j < 3; ++j) aty[j][c] += uA[j] * vA + uB[j] * vB;
    }
    const int m = wedge_mask(d1, d2, k);
    own1 |= (m == 1);
    own2 |= (m == 2);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) gram[i] = wedge::warp_sum(gram[i]);
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int c = 0; c < 3; ++c) aty[j][c] = wedge::warp_sum(aty[j][c]);
  own1 = __any_sync(0xffffffffu, own1);
  own2 = __any_sync(0xffffffffu, own2);

  float m[3][3], col[3][3];
  wedge::ridge_inverse(gram, k.lambda_ridge, m);
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      col[j][c] = m[j][0] * aty[0][c] + m[j][1] * aty[1][c] + m[j][2] * aty[2][c];

  const float dep1 = etas2depth(e[0], e[2], k);
  const float dep2 = etas2depth(e[1], e[3], k);
  // refocus blur: depth2sigma where the wedge owns a pixel, else sharp
  const float sig1 = own1 ? fabsf((1.f / dep1 - k.rho_prime) * k.s_cam + 1.f) / k.den_root : 1e-4f;
  const float sig2 = own2 ? fabsf((1.f / dep2 - k.rho_prime) * k.s_cam + 1.f) / k.den_root : 1e-4f;
  const float kS = wedge::kInvSqrt2 / 1e-4f;
  const float kR1 = wedge::kInvSqrt2 / sig1, kR2 = wedge::kInvSqrt2 / sig2;

  // pass 2: every output, written once
  const size_t offP = (size_t)p * N;
  for (int n = lane; n < N; n += 32) {
    float x, y, d1, d2, u[3];
    wedge::pixel_xy(n, R, step, x, y);
    wedge::wedge_dists(g, x, y, k.w, d1, d2);
    wedge::memberships(d1, d2, kA1, kA2, u);
    store_rgb(patches + offA + n * 3, u, col);
    wedge::memberships(d1, d2, kB1, kB2, u);
    store_rgb(patches + offB + n * 3, u, col);
    wedge::memberships(d1, d2, kS, kS, u);
    store_rgb(shpd + (offP + n) * 3, u, col);
    wedge::memberships(d1, d2, kR1, kR2, u);
    store_rgb(refoc + (offP + n) * 3, u, col);

    const float bdf = d2 >= 0.f ? d2 : fminf(fabsf(d1), fabsf(d2));
    bndry[offP + n] = expf(-(bdf * bdf) / k.delta2);
    const int mk = wedge_mask(d1, d2, k);
    mask[offP + n] = mk;
    depth[offP + n] = mk == 1 ? dep1 : (mk == 2 ? dep2 : 0.f);
  }
}

}  // namespace

// xy (B, Hp, Wp, 8), etas (B, Hp, Wp, 4), pix (B, 2, Hp, Wp, R, R, 3) ->
// patches (B, 2, Hp, Wp, R, R, 3), shpd / refoc (B, Hp, Wp, R, R, 3),
// bndry / depth (B, Hp, Wp, R, R) float32, mask (B, Hp, Wp, R, R) int32;
// L = Hp * Wp. Returns cudaGetLastError() after the launch.
extern "C" int wedge_render_launch(
    const float* xy, const float* etas, const float* pix, float* patches,
    float* shpd, float* refoc, float* bndry, float* depth, int* mask, int B,
    int L, int R, float w, float lambda_ridge, int hard, float rho_prime,
    float delta2, float numerator, float den_const, float den_factor,
    float den_root, float intercept, float s_cam, void* stream) {
  const RenderConsts k{w, lambda_ridge, hard, rho_prime, delta2, numerator,
                       den_const, den_factor, den_root, intercept, s_cam};
  const int P = B * L;
  if (P > 0) {
    const int blocks = (P + wedge::kWarpsPerBlock - 1) / wedge::kWarpsPerBlock;
    wedge_render_kernel<<<blocks, wedge::kWarpsPerBlock * 32, 0,
                          (cudaStream_t)stream>>>(xy, etas, pix, patches, shpd,
                                                  refoc, bndry, depth, mask, B,
                                                  L, R, k);
  }
  return (int)cudaGetLastError();
}
