// uint8 images to normalized floats in one pass: y = x * scale[c] + shift[c]
// with scale = 1 / (255 * std) and shift = -mean / std.
//
// Replaces the Pallas TPU kernel myconvnet_tpu/ops/pallas/normalize_u8.py
// (normalize_u8).  x is [N, H, W, C] uint8 flattened to [total]; y is the
// same shape in float32 or bf16; mean and std are [C] float32.  Each block
// folds mean and std into (scale, shift) in shared memory first, with the
// roundings of the plain version's float32 ops (a product, a correctly
// rounded reciprocal, a quotient), so a call is one launch.
//
// What bounds it on the H100: bytes.  It does 2 flops per element against
// 5 (f32 out) or 3 (bf16 out) bytes of traffic, so the floor is one read of
// x and one write of y at HBM bandwidth.  Each thread reads 16 bytes (16
// pixels' channels) with one vector load and writes them with 16-byte
// stores, when the tensors are 16-byte aligned; a scalar loop covers the
// tail and unaligned tensors.  C = 3 is the common case, so the channel of
// an element is its flat index mod C, not a vector lane.
//
// The multiply and add are rounded separately (__fmul_rn, __fadd_rn), as
// PyTorch's eager `x * scale + shift` rounds them, so the kernel matches its
// plain version bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 16;  // uint8 elements per vector load

__device__ __forceinline__ float norm(uint8_t v, float s, float b) {
  return __fadd_rn(__fmul_rn((float)v, s), b);
}

// scale[c] = 1 / (255 * std[c]), shift[c] = -mean[c] / std[c] into shared
// memory (2 * C floats); every thread of the block reads them after.
__device__ __forceinline__ void fold_stats(const float* __restrict__ mean,
                                           const float* __restrict__ stdev,
                                           int c, float* scale,
                                           float* shift) {
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    scale[i] = __fdiv_rn(1.f, __fmul_rn(255.f, stdev[i]));
    shift[i] = __fdiv_rn(-mean[i], stdev[i]);
  }
  __syncthreads();
}

__device__ __forceinline__ void store16(float* y, const float* v) {
  float4* dst = reinterpret_cast<float4*>(y);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* y, const float* v) {
  uint4 out[2];
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(out);
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = __float2bfloat16_rn(v[i]);
  uint4* dst = reinterpret_cast<uint4*>(y);
  dst[0] = out[0];
  dst[1] = out[1];
}

__device__ __forceinline__ void store1(float* y, float v) { *y = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* y, float v) {
  *y = __float2bfloat16_rn(v);
}

// Vectors [0, nvec) are 16 elements each; elements [nvec * 16, total) are
// the scalar tail, spread over the same grid.
template <typename T>
__global__ void normalize_u8_kernel(const uint8_t* __restrict__ x,
                                    const float* __restrict__ mean,
                                    const float* __restrict__ stdev,
                                    T* __restrict__ y, int64_t total,
                                    int64_t nvec, int c) {
  extern __shared__ float stats[];
  float* scale = stats;
  float* shift = stats + c;
  fold_stats(mean, stdev, c, scale, shift);
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t v = tid; v < nvec; v += step) {
    const uint4 in = reinterpret_cast<const uint4*>(x)[v];
    const uint8_t* xs = reinterpret_cast<const uint8_t*>(&in);
    int ch = (int)((v * kVec) % c);
    float out[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      out[i] = norm(xs[i], scale[ch], shift[ch]);
      ch = ch + 1 == c ? 0 : ch + 1;
    }
    store16(y + v * kVec, out);
  }
  for (int64_t e = nvec * kVec + tid; e < total; e += step) {
    const int ch = (int)(e % c);
    store1(y + e, norm(x[e], scale[ch], shift[ch]));
  }
}

template <typename T>
int launch(const void* x, const void* mean, const void* stdev, void* y,
           int64_t total, int c, void* stream) {
  constexpr int kThreads = 256;
  constexpr int64_t kMaxBlocks = 132 * 16;  // 16 resident blocks per SM
  if (total == 0) return (int)cudaGetLastError();
  if (c <= 0 || c > 4096) return (int)cudaErrorInvalidValue;
  const bool vec = (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  const int64_t nvec = vec ? total / kVec : 0;
  const int64_t work = nvec + (total - nvec * kVec);
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  normalize_u8_kernel<T><<<(unsigned)blocks, kThreads,
                           2 * c * sizeof(float),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(stdev), static_cast<T*>(y), total, nvec, c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mcn_normalize_u8_f32(const void* x, const void* mean,
                                    const void* stdev, void* y, int64_t total,
                                    int c, void* stream) {
  return launch<float>(x, mean, stdev, y, total, c, stream);
}

extern "C" int mcn_normalize_u8_bf16(const void* x, const void* mean,
                                     const void* stdev, void* y,
                                     int64_t total, int c, void* stream) {
  return launch<__nv_bfloat16>(x, mean, stdev, y, total, c, stream);
}
