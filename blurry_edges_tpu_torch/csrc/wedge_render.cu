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
// ~24, the boundary map ~14 and the depth 2; this kernel computes each of
// them once (chip_smoke.py takes its bound from these ~420). Counted as
// instructions issued, the work is close behind the bytes (~30 us at one
// instruction a clock a scheduler), and its chains of dependent
// instructions (erff, the distances) need many warps in flight to issue at
// that rate.
//
// Design: one warp a patch, each lane on every 32nd pixel, no block-wide
// barrier, so that warps in both passes interleave on an SM. The colors are
// needed before anything can be rendered, so the warp walks the pixels
// twice.
// - The warp first queues its patch's two images (2 x 5,292 contiguous
//   bytes) into its shared memory by cp.async, 16-byte chunks for the
//   bodies and 4-byte copies at unaligned ends, and works out the geometry
//   while they arrive: all of a patch's loads in flight at once, where
//   loads in the pixel loop waited a round trip each round.
// - Pass 1 reads the pixels there, accumulates the Gram and A^T y sums of
//   both images in registers (reduced with __shfl_xor_sync) and votes
//   whether wedge 1 or 2 owns any pixel (__any_sync), which picks the
//   refocus blur. Over each pixel's six values it writes what pass 2 needs
//   of it: both images' indicators (their erff), the two distances, and
//   the mask in the sign bits of image A's indicators (never negative).
// - Pass 2, with the colors, reads them back (the lane that wrote them) and
//   computes only the sharpened and refocused indicators, the four renders,
//   the boundary map and the depth: ~200 instructions a pixel where
//   recomputing took ~415. Every output is written once, straight into the
//   caller's layout; a warp's store covers 32 consecutive pixels, so its
//   bytes are contiguous (the RGB ones, at a 12-byte stride, merge in L2).
// - Shared memory (dynamic, sized by R) is 42 KB a 4-warp block at R = 21:
//   5 blocks an SM, 20 warps; the registers (80 a thread) would allow 6.
// - What was tried and ran slower on the card (PERF.md): staging groups of
//   patches in shared memory with block-wide passes, or with a team of
//   warps for each pass handing over by named barriers (~100 KB a block, 16
//   warps an SM to hide the per-pixel chains); writing the RGB outputs
//   through shared memory as 16-byte stores (more instructions, no fewer
//   bytes); unrolling either pass.
// The DfD constants and the hard-mask switch are kernel arguments.

#include <stdint.h>

#include "async_copy.cuh"
#include "wedge_common.cuh"

namespace {

using namespace async_copy;

constexpr int kWarps = 4;      // warps a block, a patch each
constexpr int kMinBlocks = 5;  // blocks an SM, for the register budget

struct RenderConsts {
  float w, lambda_ridge;
  int hard;                 // 1: wedge interiors (densify w); 0: boundary band
  float rho_prime;          // refocus optical power
  float delta2;             // boundary-map width squared
  float numerator, den_const, den_factor, den_root, intercept, s_cam;
};

// shared memory a block: each warp's patch's two images (each with room to
// align it as its source is) for patches of N pixels
size_t smem_bytes(int N) { return (size_t)kWarps * 2 * round4(3 * N + 3) * 4; }

// a mask bit into, and out of, the sign of a non-negative float
__device__ __forceinline__ float with_sign(float x, int bit) {
  return __uint_as_float(__float_as_uint(x) | ((uint32_t)bit << 31));
}
__device__ __forceinline__ int sign_bit(float x) { return (int)(__float_as_uint(x) >> 31); }

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

__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
wedge_render_kernel(const float* __restrict__ xy, const float* __restrict__ etas,
                    const float* __restrict__ pix, float* __restrict__ patches,
                    float* __restrict__ shpd, float* __restrict__ refoc,
                    float* __restrict__ bndry, float* __restrict__ depth,
                    int* __restrict__ mask, int B, int L, int R, RenderConsts k) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = blockIdx.x * kWarps + warp;
  if (p >= B * L) return;  // the whole warp leaves together
  const int b = p / L, l = p - b * L;

  const int N = R * R;
  const float step = 2.f / (float)(R - 1);
  // (B, 2, Hp, Wp, R, R, 3): image i of pair b, patch l
  const size_t offA = ((size_t)(b * 2) * L + l) * N * 3;
  const size_t offB = ((size_t)(b * 2 + 1) * L + l) * N * 3;
  // the patch's two images, copied in while the geometry is worked out;
  // pixel n's values at pa[3n + c] and pb[3n + c], which pass 1 overwrites
  // with what pass 2 needs of the pixel: pa hA1 (sign: mask bit 0), hA2
  // (sign: mask bit 1), hB1; pb hB2, d1, d2
  const int rn = round4(3 * N + 3);
  float* img = smem + (size_t)warp * 2 * rn;
  stage_range(img, pix + offA, 3 * N, lane);
  stage_range(img + rn, pix + offB, 3 * N, lane);
  cp_async_commit();
  float* pa = img + misalign(pix + offA);
  float* pb = img + rn + misalign(pix + offB);

  float q[8], e[4];
#pragma unroll
  for (int i = 0; i < 8; ++i) q[i] = __ldg(xy + (size_t)p * 8 + i);
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = __ldg(etas + (size_t)p * 4 + i);
  const wedge::Geometry g = wedge::make_geometry(q, false);
  const float kA1 = wedge::kInvSqrt2 / e[0], kA2 = wedge::kInvSqrt2 / e[1];
  const float kB1 = wedge::kInvSqrt2 / e[2], kB2 = wedge::kInvSqrt2 / e[3];
  cp_async_wait<0>();
  __syncwarp();

  // pass 1: joint Gram and A^T y sums over both images, wedge ownership
  float gram[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float aty[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  bool own1 = false, own2 = false;
  for (int n = lane; n < N; n += 32) {
    float x, y, d1, d2, uA[3], uB[3];
    wedge::pixel_xy(n, R, step, x, y);
    wedge::wedge_dists(g, x, y, k.w, d1, d2);
    const float hA1 = wedge::indicator(d1, kA1), hA2 = wedge::indicator(d2, kA2);
    const float hB1 = wedge::indicator(d1, kB1), hB2 = wedge::indicator(d2, kB2);
    wedge::from_indicators(hA1, hA2, uA);
    wedge::from_indicators(hB1, hB2, uB);
    wedge::add_gram(uA, gram);
    wedge::add_gram(uB, gram);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float vA = pa[n * 3 + c], vB = pb[n * 3 + c];
#pragma unroll
      for (int j = 0; j < 3; ++j) aty[j][c] += uA[j] * vA + uB[j] * vB;
    }
    const int m = wedge_mask(d1, d2, k);
    own1 |= (m == 1);
    own2 |= (m == 2);
    pa[n * 3] = with_sign(hA1, m & 1);
    pa[n * 3 + 1] = with_sign(hA2, m >> 1);
    pa[n * 3 + 2] = hB1;
    pb[n * 3] = hB2;
    pb[n * 3 + 1] = d1;
    pb[n * 3 + 2] = d2;
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

  // pass 2: every output, written once, from what pass 1 kept (each lane
  // reads the pixels it wrote)
  const size_t offP = (size_t)p * N;
  for (int n = lane; n < N; n += 32) {
    const float a1 = pa[n * 3], a2 = pa[n * 3 + 1];
    const float d1 = pb[n * 3 + 1], d2 = pb[n * 3 + 2];
    float u[3];
    wedge::from_indicators(fabsf(a1), fabsf(a2), u);
    store_rgb(patches + offA + n * 3, u, col);
    wedge::from_indicators(pa[n * 3 + 2], pb[n * 3], u);
    store_rgb(patches + offB + n * 3, u, col);
    wedge::memberships(d1, d2, kS, kS, u);
    store_rgb(shpd + (offP + n) * 3, u, col);
    wedge::memberships(d1, d2, kR1, kR2, u);
    store_rgb(refoc + (offP + n) * 3, u, col);

    const float bdf = d2 >= 0.f ? d2 : fminf(fabsf(d1), fabsf(d2));
    bndry[offP + n] = expf(-(bdf * bdf) / k.delta2);
    const int mk = sign_bit(a1) | (sign_bit(a2) << 1);
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
    const size_t smem = smem_bytes(R * R);
    if (smem > 48 * 1024)  // past the default a block may take
      cudaFuncSetAttribute(wedge_render_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    wedge_render_kernel<<<(P + kWarps - 1) / kWarps, kWarps * 32, smem,
                          (cudaStream_t)stream>>>(xy, etas, pix, patches, shpd, refoc, bndry,
                                                  depth, mask, B, L, R, k);
  }
  return (int)cudaGetLastError();
}

// Dynamic shared memory a block of the render takes at patch size R.
extern "C" int wedge_render_smem_bytes(int R) { return (int)smem_bytes(R * R); }
