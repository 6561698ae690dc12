// Per-patch wedge geometry shared by wedge_colors.cu and wedge_render.cu:
// the two wedges' signed distance fields, the soft memberships, the warp
// reductions and the Cayley-Hamilton inverse of the symmetric 3x3 Gram
// matrix. One warp owns one patch; each lane walks the patch's pixels
// n = lane, lane + 32, ... (14 of the 441 pixels of a 21x21 patch).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace wedge {

constexpr int kWarpsPerBlock = 4;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kPi = 3.141592653589793f;
constexpr float kInvSqrt2 = 0.7071067811865476f;

// floor-mod into [0, 2pi), as jnp.mod / torch.remainder compute it
__device__ __forceinline__ float mod_2pi(float x) {
  float r = fmodf(x, kTwoPi);
  return (r != 0.f && r < 0.f) ? r + kTwoPi : r;
}

// signed distance to one wedge edge, with the soft back-extension
// sqrt(d^2 + (axial * w)^2) behind the corner (axial < 0)
__device__ __forceinline__ float edge_dist(float x, float y, float cx, float cy,
                                           float s, float c, float w) {
  const float dx = x - cx, dy = y - cy;
  const float d = -s * dx + c * dy;
  const float ax = c * dx + s * dy;
  if (ax < 0.f) {
    const float soft = sqrtf(d * d + (ax * w) * (ax * w));
    return d < 0.f ? -soft : soft;
  }
  return d;
}

// the per-patch trig, done once per patch and not per pixel
struct Geometry {
  float x0, y0, x1, y1;
  float s11, c11, s12, c12, s21, c21, s22, c22;
  float sgn1, sgn2;
};

// p: (x0, y0, x1, y1, theta1, phi1, theta2, phi2); wrap: wrap the angles
// into [0, 2pi) first
__device__ __forceinline__ Geometry make_geometry(const float* p, bool wrap) {
  Geometry g;
  g.x0 = p[0]; g.y0 = p[1]; g.x1 = p[2]; g.y1 = p[3];
  float th1 = p[4], ph1 = p[5], th2 = p[6], ph2 = p[7];
  if (wrap) {
    th1 = mod_2pi(th1); ph1 = mod_2pi(ph1);
    th2 = mod_2pi(th2); ph2 = mod_2pi(ph2);
  }
  sincosf(th1, &g.s11, &g.c11);
  sincosf(th1 + ph1, &g.s12, &g.c12);
  sincosf(th2, &g.s21, &g.c21);
  sincosf(th2 + ph2, &g.s22, &g.c22);
  g.sgn1 = mod_2pi(ph1) < kPi ? 1.f : -1.f;
  g.sgn2 = mod_2pi(ph2) < kPi ? 1.f : -1.f;
  return g;
}

// signed distances of pixel (x, y) to wedge 1 and wedge 2 (positive inside);
// wedge 1 tests its interior with strict inequalities, wedge 2 non-strict
__device__ __forceinline__ void wedge_dists(const Geometry& g, float x, float y,
                                            float w, float& dist1, float& dist2) {
  const float d11 = edge_dist(x, y, g.x0, g.y0, g.s11, g.c11, w);
  const float d12 = edge_dist(x, y, g.x0, g.y0, g.s12, g.c12, w);
  const float d21 = edge_dist(x, y, g.x1, g.y1, g.s21, g.c21, w);
  const float d22 = edge_dist(x, y, g.x1, g.y1, g.s22, g.c22, w);
  const float ind1 = g.sgn1 * ((g.sgn1 * d11 > 0.f && g.sgn1 * d12 < 0.f) ? 1.f : -1.f);
  const float ind2 = g.sgn2 * ((g.sgn2 * d21 >= 0.f && g.sgn2 * d22 <= 0.f) ? 1.f : -1.f);
  dist1 = fminf(fabsf(d11), fabsf(d12)) * ind1;
  dist2 = fminf(fabsf(d21), fabsf(d22)) * ind2;
}

// soft memberships (u0, u1, u2) from the distances; k = 1 / (sqrt(2) eta)
__device__ __forceinline__ void memberships(float dist1, float dist2, float k1,
                                            float k2, float u[3]) {
  const float h1 = 0.5f * (1.f + erff(dist1 * k1));
  const float h2 = 0.5f * (1.f + erff(dist2 * k2));
  u[0] = (1.f - h1) * (1.f - h2);
  u[1] = h1 * (1.f - h2);
  u[2] = h2;
}

// eta = 10^(2 erf(c) - 2)
__device__ __forceinline__ float coef_to_eta(float c) {
  return exp10f(erff(c) * 2.f - 2.f);
}

// pixel coordinates of flat pixel n in the patch frame [-1, 1]^2
__device__ __forceinline__ void pixel_xy(int n, int R, float step, float& x,
                                         float& y) {
  const int r = n / R;
  x = -1.f + (float)(n - r * R) * step;
  y = -1.f + (float)r * step;
}

// butterfly sum: every lane ends with the warp's total
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the six Gram sums (g00, g01, g02, g11, g12, g22) of the memberships
__device__ __forceinline__ void add_gram(const float u[3], float g[6]) {
  g[0] += u[0] * u[0]; g[1] += u[0] * u[1]; g[2] += u[0] * u[2];
  g[3] += u[1] * u[1]; g[4] += u[1] * u[2]; g[5] += u[2] * u[2];
}

// Cayley-Hamilton inverse of the symmetric (Gram + lambda I):
// det = (tr^3 - 3 tr tr(A^2) + 2 tr(A^3)) / 6, adj = A^2 - tr A + c I,
// in double: in float the trace identities cancel catastrophically when a
// wedge owns almost no pixel (det ~ 2e4 against tr^3 ~ 7e8 for a pair's
// 882-pixel Gram matrix). Once per patch, so the FP64 rate does not matter.
__device__ __forceinline__ void ridge_inverse(const float g[6], float lambda,
                                              float m[3][3]) {
  const double a00 = (double)g[0] + lambda, a11 = (double)g[3] + lambda;
  const double a22 = (double)g[5] + lambda;
  const double a01 = g[1], a02 = g[2], a12 = g[4];
  const double tr = a00 + a11 + a22;
  const double b00 = a00 * a00 + a01 * a01 + a02 * a02;
  const double b11 = a01 * a01 + a11 * a11 + a12 * a12;
  const double b22 = a02 * a02 + a12 * a12 + a22 * a22;
  const double b01 = a00 * a01 + a01 * a11 + a02 * a12;
  const double b02 = a00 * a02 + a01 * a12 + a02 * a22;
  const double b12 = a01 * a02 + a11 * a12 + a12 * a22;
  const double tr2 = b00 + b11 + b22;
  const double tr3 = b00 * a00 + b01 * a01 + b02 * a02
                   + b01 * a01 + b11 * a11 + b12 * a12
                   + b02 * a02 + b12 * a12 + b22 * a22;
  const double det = (tr * tr * tr - 3.0 * tr * tr2 + 2.0 * tr3) / 6.0;
  const double coef = (tr * tr - tr2) * 0.5;
  const double inv_det = 1.0 / det;
  m[0][0] = (float)((b00 - tr * a00 + coef) * inv_det);
  m[1][1] = (float)((b11 - tr * a11 + coef) * inv_det);
  m[2][2] = (float)((b22 - tr * a22 + coef) * inv_det);
  m[0][1] = m[1][0] = (float)((b01 - tr * a01) * inv_det);
  m[0][2] = m[2][0] = (float)((b02 - tr * a02) * inv_det);
  m[1][2] = m[2][1] = (float)((b12 - tr * a12) * inv_det);
}

}  // namespace wedge
