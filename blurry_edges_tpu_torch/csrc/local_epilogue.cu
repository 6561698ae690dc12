// The LocalStage CNN's float32 tail after a convolution, in one pass: the
// convolution's bias and eval-mode BatchNorm, optionally a residual
// convolution's bias and BatchNorm and the sum, Smish, and optionally a
// max-pool. Float32 in and out, channels-last as the convolutions write it
// (the CNN's NHWC input, permuted to NCHW at entry, makes cuDNN keep every
// activation channels-last), or (N, C) for the head.
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA, which
// fuses it. Added because in eager PyTorch each step of the chain is its own
// pass over a whole activation tensor (the bias, which PyTorch adds after
// cuDNN's convolution, cuDNN's inference BatchNorm, Smish's four
// elementwise kernels, the residual sum, the max-pool).
//
// Bound on an H100: bytes. At the serving shapes (8,192 patches a 147x147
// pair) the ten junctions of a forward read the convolutions' outputs once
// and write the next layer's input once, 242,304 floats a patch, 7.94 GB a
// pair: ~2.4 ms at 3.35 TB/s. Smish takes ~70 float32 instructions an
// element (expf, an IEEE division, log1pf, tanhf) over ~117,000 elements a
// patch, ~2 ms at one instruction a lane a clock: the two bounds are close,
// so the kernel does no work twice (Smish once an element, also under a
// pool's overlapping windows).
//
// Numerics. Smish is PyTorch's float32 chain x * tanh(log1p(sigmoid(x)))
// with sigmoid = 1 / (1 + exp(-x)), each step rounded to float32 as
// PyTorch's kernels round it (built without fast math, so expf, log1pf and
// tanhf are the CUDA library's accurate ones). The max-pool is exact, NaN
// propagating, as PyTorch's. The bias is added and rounded first, as
// PyTorch adds it to cuDNN's output. The BatchNorm forms each channel's scale,
// weight * rsqrtf(var + eps), from the module's tensors at the call (nothing
// folded ahead, so a loaded state dict or a training step is seen at once),
// then fma(x - mean, scale, bias): with a fresh BatchNorm's statistics
// (mean 0, variance 1, weight 1, bias 0) that is cuDNN's inference result to
// the bit; with others it lies within a few ulps of the terms' size.
//
// Design. A float4 holds four neighbouring channels of one pixel. Without a
// pool a block takes `tile` consecutive floats (16,384 by default, 16
// float4 a thread); with a pool a block takes one image's `cb` channels (the
// most, a multiple of 4 dividing C, within 16,384 floats), all of its H x W
// pixels, so that every window lies in the block. At entry the block forms
// the BatchNorm constants of its channels in shared memory. Each thread then
// issues up to 4 float4 loads of the input (and the residual) before it
// computes any, so each keeps 64 (128) bytes in flight. Without a pool the
// results are stored as float4 at the same offsets; with a pool they go to
// shared memory (the only round trip), and after one barrier each output
// takes the max of its window there.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // float4 loads a thread keeps in flight

// A convolution's bias (null: none) and its eval-mode BatchNorm's tensors,
// as the modules hold them.
struct Norm {
  const float* conv_bias;
  const float* weight;
  const float* bias;
  const float* mean;
  const float* var;
  double eps;
};

struct Args {
  const float* x;
  const float* r;     // the residual; null: none
  Norm nx, nr;
  bool r_norm;        // false: the residual is added as it is (no bias, no norm)
  float* out;
};

// The per-channel constants in shared memory, structure of arrays: for
// `count` channels, kArrays rows of `count` floats: x's scale, mean, bias
// and convolution bias, then the residual's. A channel's four in a row are
// read as one float4 where four neighbouring channels are (channels-last).
template <bool kRes>
constexpr int kArrays = kRes ? 8 : 4;

__device__ __forceinline__ void channel_constants(const Norm& n, int c, float* k, int count) {
  k[0] = __fmul_rn(n.weight[c], rsqrtf(__fadd_rn(n.var[c], (float)n.eps)));
  k[count] = n.mean[c];
  k[2 * count] = n.bias[c];
  k[3 * count] = n.conv_bias ? n.conv_bias[c] : 0.f;
}

// Channels [c_lo, c_lo + count) into consts, column c - c_lo.
template <bool kRes>
__device__ void load_constants(const Args& a, float* consts, int c_lo, int count) {
  for (int i = threadIdx.x; i < count; i += kThreads) {
    channel_constants(a.nx, c_lo + i, consts + i, count);
    if (kRes && a.r_norm) channel_constants(a.nr, c_lo + i, consts + 4 * count + i, count);
  }
}

// The convolution's bias added, then (x - mean) * scale + bias with the
// product and the sum rounded once together. k: scale, mean, bias, bias.
__device__ __forceinline__ float normalize(float x, const float* k, bool conv_bias) {
  if (conv_bias) x = __fadd_rn(x, k[3]);
  return __fmaf_rn(__fsub_rn(x, k[1]), k[0], k[2]);
}

// PyTorch's float32 Smish: sigmoid, log1p, tanh and the product, each
// rounded to float32.
__device__ __forceinline__ float smish(float v) {
  const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
  return __fmul_rn(v, tanhf(log1pf(sig)));
}

// One element's result; k: its channel's kArrays constants.
template <bool kRes>
__device__ __forceinline__ float value(const Args& a, const float* k, float xv, float rv) {
  float y = normalize(xv, k, a.nx.conv_bias);
  if (kRes) y = __fadd_rn(y, a.r_norm ? normalize(rv, k + 4, a.nr.conv_bias) : rv);
  return smish(y);
}

// The four neighbouring channels c .. c + 3 of one pixel (c a multiple of 4).
template <bool kRes>
__device__ __forceinline__ float4 value4(const Args& a, const float* consts, int count,
                                         float4 xv, float4 rv, int c) {
  constexpr int n = kArrays<kRes>;
  const float* xs = reinterpret_cast<const float*>(&xv);
  const float* rs = reinterpret_cast<const float*>(&rv);
  float4 kv[n];
#pragma unroll
  for (int i = 0; i < n; ++i) kv[i] = *reinterpret_cast<const float4*>(consts + i * count + c);
  float4 y;
  float* ys = reinterpret_cast<float*>(&y);
  float k[n];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < n; ++i) k[i] = reinterpret_cast<const float*>(&kv[i])[j];
    ys[j] = value<kRes>(a, k, xs[j], kRes ? rs[j] : 0.f);
  }
  return y;
}

// No pool: the block's `tile` floats from `base`. The channel of flat
// element i is i % C.
template <bool kRes>
__global__ void __launch_bounds__(kThreads)
local_epilogue_kernel(Args a, long long total, int C, int tile) {
  extern __shared__ __align__(16) float smem[];
  load_constants<kRes>(a, smem, 0, C);
  __syncthreads();
  const long long base = (long long)blockIdx.x * tile;
  const int n4 = (int)(min((long long)tile, total - base) >> 2);
  const int c0 = (int)(base % C);
  const float4* x4 = reinterpret_cast<const float4*>(a.x + base);
  const float4* r4 = reinterpret_cast<const float4*>((kRes ? a.r : a.x) + base);
  float4* o4 = reinterpret_cast<float4*>(a.out + base);
  for (int g0 = threadIdx.x; g0 < n4; g0 += kThreads * kUnroll) {
    float4 xv[kUnroll], rv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int g = g0 + u * kThreads;
      if (g < n4) {
        xv[u] = __ldg(x4 + g);
        if (kRes) rv[u] = __ldg(r4 + g);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int g = g0 + u * kThreads;
      if (g >= n4) break;
      o4[g] = value4<kRes>(a, smem, C, xv[u], rv[u], (c0 + 4 * g) % C);
    }
  }
}

struct PoolShape {
  int C, H, W;
  int k, s, p;   // window, stride, padding
  int Ho, Wo;
  int cb;        // channels a block
};

// With a pool: block b takes image b / (C / cb), channels cs .. cs + cb.
// Shared memory holds the block's constants, then its H x W x cb results,
// pixel-major as the input.
template <bool kRes>
__global__ void __launch_bounds__(kThreads)
local_epilogue_pool_kernel(Args a, PoolShape sh) {
  extern __shared__ __align__(16) float smem[];
  const int C = sh.C, cb = sh.cb, HW = sh.H * sh.W, HWo = sh.Ho * sh.Wo;
  const int slices = C / cb;
  const long long n = blockIdx.x / slices;
  const int cs = (int)(blockIdx.x % slices) * cb;
  load_constants<kRes>(a, smem, cs, cb);
  float* act = smem + kArrays<kRes> * cb;
  __syncthreads();

  const int n4 = HW * cb / 4;
  for (int g0 = threadIdx.x; g0 < n4; g0 += kThreads * kUnroll) {
    float4 xv[kUnroll], rv[kUnroll];
    long long off[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int g = g0 + u * kThreads;
      if (g < n4) {
        // float4 g: pixel g / (cb / 4), the block's channels 4 (g % (cb / 4)) on
        off[u] = (n * HW + g / (cb / 4)) * C + cs + 4 * (g % (cb / 4));
        xv[u] = __ldg(reinterpret_cast<const float4*>(a.x + off[u]));
        if (kRes) rv[u] = __ldg(reinterpret_cast<const float4*>(a.r + off[u]));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int g = g0 + u * kThreads;
      if (g >= n4) break;
      reinterpret_cast<float4*>(act)[g] = value4<kRes>(a, smem, cb, xv[u], rv[u],
                                                       4 * (g % (cb / 4)));
    }
  }
  __syncthreads();

  // the max-pool as PyTorch's max_pool2d: windows clipped at the edges, a
  // NaN taken, the first maximum kept
  for (int o = threadIdx.x; o < HWo * cb; o += kThreads) {
    const int op = o / cb, cc = o - op * cb;
    const int oy = op / sh.Wo, ox = op - oy * sh.Wo;
    const int y0 = oy * sh.s - sh.p, x0 = ox * sh.s - sh.p;
    float m = -INFINITY;
    for (int dy = 0; dy < sh.k; ++dy) {
      const int iy = y0 + dy;
      if (iy < 0 || iy >= sh.H) continue;
      for (int dx = 0; dx < sh.k; ++dx) {
        const int ix = x0 + dx;
        if (ix < 0 || ix >= sh.W) continue;
        const int pix = iy * sh.W + ix;
        const float v = act[pix * cb + cc];
        if (v > m || isnan(v)) m = v;
      }
    }
    a.out[(n * HWo + op) * C + cs + cc] = m;
  }
}

template <typename Kernel>
void set_smem(Kernel kernel, size_t bytes) {
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <bool kRes>
void launch(const Args& a, long long N, int C, int H, int W, int pool_k, int pool_s,
            int pool_p, int tile, int cb, cudaStream_t stream) {
  if (pool_k == 0) {
    const long long total = N * C * H * W;
    const size_t smem = sizeof(float) * kArrays<kRes> * C;
    auto kernel = local_epilogue_kernel<kRes>;
    set_smem(kernel, smem);
    kernel<<<(unsigned)((total + tile - 1) / tile), kThreads, smem, stream>>>(
        a, total, C, tile);
    return;
  }
  const PoolShape sh{C, H, W, pool_k, pool_s, pool_p, (H + 2 * pool_p - pool_k) / pool_s + 1,
                     (W + 2 * pool_p - pool_k) / pool_s + 1, cb};
  const size_t smem = sizeof(float) * (kArrays<kRes> * cb + (size_t)cb * H * W);
  auto kernel = local_epilogue_pool_kernel<kRes>;
  set_smem(kernel, smem);
  kernel<<<(unsigned)(N * (C / cb)), kThreads, smem, stream>>>(a, sh);
}

}  // namespace

// out = maxpool(smish(bn_x(x + x_conv_bias) [+ bn_r(r + r_conv_bias)])) over
// N images of C x H x W float32, channels-last ((N, C): H = W = 1), 16-byte
// aligned, C a multiple of 4; r has x's shape and layout. A null conv bias:
// none. r = null: no residual; r_weight = null: the residual added as it
// is. pool_k = 0: no pool, out has x's shape and layout, a block takes
// `tile` floats (a multiple of 4); else out is (N, C, Ho, Wo) channels-last,
// Ho = (H + 2 pool_p - pool_k) / pool_s + 1, and a block takes `cb`
// channels of an image (a multiple of 4 dividing C). Returns the launch's
// cudaError_t.
extern "C" int local_epilogue_launch(
    const float* x, const float* x_conv_bias, const float* x_weight, const float* x_bias,
    const float* x_mean, const float* x_var, double x_eps, const float* r,
    const float* r_conv_bias, const float* r_weight, const float* r_bias, const float* r_mean,
    const float* r_var, double r_eps, float* out,
    long long N, int C, int H, int W, int pool_k, int pool_s, int pool_p, int tile, int cb,
    void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  const Args a{x, r, {x_conv_bias, x_weight, x_bias, x_mean, x_var, x_eps},
               {r_conv_bias, r_weight, r_bias, r_mean, r_var, r_eps}, r_weight != nullptr, out};
  cudaStream_t st = (cudaStream_t)stream;
  if (r != nullptr)
    launch<true>(a, N, C, H, W, pool_k, pool_s, pool_p, tile, cb, st);
  else
    launch<false>(a, N, C, H, W, pool_k, pool_s, pool_p, tile, cb, st);
  return (int)cudaGetLastError();
}
