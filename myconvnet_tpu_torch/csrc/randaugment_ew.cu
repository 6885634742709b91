// One RandAugment layer of elementwise ops over float32 [N, H, W, C]
// images in [0, 1], one op per image: y[n] = op[n](x[n]).
//
// Replaces the Pallas TPU kernel myconvnet_tpu/ops/pallas/randaugment_ew.py
// (apply_layer).  The ops, in PALLAS_POOL's order, are the switch below:
// identity, autocontrast, invert, posterize, solarize, solarize_add,
// contrast, brightness.  params is [N, 2 + 2C] float32 per image: the signed
// magnitude in [-1, 1], the gray mean, the per-channel min, the
// per-channel max (the statistics come from torch reductions before the
// launch, as JAX computes them in XLA before its kernel).
//
// What bounds it on the H100: bytes.  One read and one write per element
// at a few operations each.  blockIdx.y is the image: a block reads its
// image's op index and parameters from device memory (no host sync), folds
// them into per-channel constants in shared memory, and every thread of it
// takes the same branch.  Each thread moves 4 elements a step with 16-byte
// loads and stores when the image's elements are a multiple of 4 and the
// tensors are 16-byte aligned (W * C = 672 floats a row at 224x224); a
// scalar loop covers the rest.  The channel of an element is its index in
// the image mod C (the image starts at a multiple of C).
//
// Rounding: each product, sum and quotient is rounded on its own (_rn
// intrinsics, IEEE division), as the plain PyTorch version rounds them:
// nvcc would contract a * b + c into an FMA, and posterize's floor turns
// one ulp into a whole level.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kIdentity = 0, kAutocontrast = 1, kInvert = 2, kPosterize = 3,
              kSolarize = 4, kSolarizeAdd = 5, kContrast = 6, kBrightness = 7;

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.f), 1.f);
}

// Per-image constants: a (the op's scalar), b, and per channel lo, scale
// and whether hi > lo (autocontrast).
struct Consts {
  int op;
  float a, b;
};

__device__ __forceinline__ float apply(const Consts& k, float v, int ch,
                                       const float* lo, const float* scale,
                                       const float* stretch) {
  switch (k.op) {
    case kAutocontrast:
      return stretch[ch] != 0.f
                 ? clip01(__fmul_rn(__fsub_rn(v, lo[ch]), scale[ch]))
                 : v;
    case kInvert:
      return __fsub_rn(1.f, v);
    case kPosterize:  // a = step (a power of two)
      return clip01(__fdiv_rn(
          __fmul_rn(floorf(__fdiv_rn(__fmul_rn(v, 255.f), k.a)), k.a),
          255.f));
    case kSolarize:  // a = threshold
      return v < k.a ? v : __fsub_rn(1.f, v);
    case kSolarizeAdd:  // a = the added amount
      return v < 0.5f ? clip01(__fadd_rn(v, k.a)) : v;
    case kContrast:  // a = factor, b = gray mean
      return clip01(__fadd_rn(k.b, __fmul_rn(__fsub_rn(v, k.b), k.a)));
    case kBrightness:  // a = factor
      return clip01(__fmul_rn(v, k.a));
    default:
      return v;
  }
}

__global__ void randaugment_ew_kernel(const float* __restrict__ x,
                                      const int* __restrict__ op_idx,
                                      const float* __restrict__ params,
                                      float* __restrict__ y,
                                      int64_t per_image, int c, bool vec) {
  extern __shared__ float chan[];  // lo, scale, stretch: 3 * c floats
  float* lo = chan;
  float* scale = chan + c;
  float* stretch = chan + 2 * c;
  const int img = blockIdx.y;
  const float* row = params + (int64_t)img * (2 + 2 * c);
  const float mag = row[0];
  const float m = fabsf(mag);
  Consts k;
  k.op = op_idx[img];
  k.a = 0.f;
  k.b = row[1];
  switch (k.op) {
    case kPosterize: {
      const float levels = exp2f(floorf(__fsub_rn(8.f, __fmul_rn(m, 4.f))));
      k.a = __fdiv_rn(256.f, levels);
      break;
    }
    case kSolarize:
      k.a = __fsub_rn(1.f, m);
      break;
    case kSolarizeAdd:
      k.a = __fmul_rn(m, (float)(110.0 / 255.0));
      break;
    case kContrast:
    case kBrightness:
      k.a = __fadd_rn(1.f, __fmul_rn(0.9f, mag));
      break;
    default:
      break;
  }
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    const float l = row[2 + i], h = row[2 + c + i];
    lo[i] = l;
    scale[i] = __fdiv_rn(1.f, fmaxf(__fsub_rn(h, l), 1e-5f));
    stretch[i] = h > l ? 1.f : 0.f;
  }
  __syncthreads();
  const float* src = x + (int64_t)img * per_image;
  float* dst = y + (int64_t)img * per_image;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {
    for (int64_t v = tid; v < per_image / 4; v += step) {
      float4 q = reinterpret_cast<const float4*>(src)[v];
      int ch = (int)((v * 4) % c);
      float* e = reinterpret_cast<float*>(&q);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        e[i] = apply(k, e[i], ch, lo, scale, stretch);
        ch = ch + 1 == c ? 0 : ch + 1;
      }
      reinterpret_cast<float4*>(dst)[v] = q;
    }
  } else {
    for (int64_t e = tid; e < per_image; e += step)
      dst[e] = apply(k, src[e], (int)(e % c), lo, scale, stretch);
  }
}

}  // namespace

// x, op_idx [N] int32, params [N, 2 + 2C], y, n, elements per image, c,
// stream
extern "C" int mcn_randaugment_ew_f32(const void* x, const void* op_idx,
                                      const void* params, void* y, int n,
                                      int64_t per_image, int c,
                                      void* stream) {
  constexpr int kThreads = 256;
  if (n == 0 || per_image == 0) return (int)cudaGetLastError();
  if (c <= 0 || c > 4096 || n > 65535) return (int)cudaErrorInvalidValue;
  const bool vec = per_image % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)y % 16 == 0;
  const int64_t work = vec ? per_image / 4 : per_image;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 64) blocks = 64;  // with N images: 16 resident blocks per SM
  const dim3 grid((unsigned)blocks, (unsigned)n);
  randaugment_ew_kernel<<<grid, kThreads, 3 * c * sizeof(float),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(op_idx),
      static_cast<const float*>(params), static_cast<float*>(y), per_image,
      c, vec);
  return (int)cudaGetLastError();
}
