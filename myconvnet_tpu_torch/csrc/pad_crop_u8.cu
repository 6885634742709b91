// CIFAR-style training input in one pass: per-image integer pad-and-crop
// (zero fill outside the frame), optional horizontal flip, normalize.
//
// Replaces the Pallas TPU kernel myconvnet_tpu/ops/pallas/pad_crop_u8.py
// (pad_crop_flip_normalize).  x is [N, H, W, C] uint8; offsets is [N, 2]
// int32 (row shift sy, column shift sx, each in [-pad, pad]); flip is [N]
// bool bytes (non-zero flips); mean and std are [C] float32, folded per
// block into scale = 1 / (255 * std) and shift = -mean / std as in
// normalize_u8.cu; y is [N, H, W, C] float32 or bf16.
//
//   y[n, r, q, c] = v * scale[c] + shift[c],
//   v = x[n, r + sy, q' + sx, c] inside the frame, else 0,
//   q' = W - 1 - q when the image is flipped, else q.
//
// Crop first, then flip, as the Pallas kernel does (it rolls and masks,
// then flips the cropped block).  The TPU's flip is a permutation matmul
// (lax.rev has no Mosaic lowering); here it is the index reversal above.
// A pixel outside the frame reads 0 before normalizing, so it comes out as
// -mean / std.  Offsets and flips are read on the device: no host sync.
//
// What bounds it on the H100: bytes (one read of x, one write of y), as for
// normalize_u8.  One thread per output element: consecutive threads write
// consecutive elements, and their reads are consecutive within a row.
// Multiply and add round separately, as in the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void store1(float* y, float v) { *y = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* y, float v) {
  *y = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void pad_crop_kernel(const uint8_t* __restrict__ x,
                                const int* __restrict__ offsets,
                                const uint8_t* __restrict__ flip,
                                const float* __restrict__ mean,
                                const float* __restrict__ stdev,
                                T* __restrict__ y, int64_t total, int h, int w,
                                int c) {
  extern __shared__ float stats[];
  float* scale = stats;
  float* shift = stats + c;
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    scale[i] = __fdiv_rn(1.f, __fmul_rn(255.f, stdev[i]));
    shift[i] = __fdiv_rn(-mean[i], stdev[i]);
  }
  __syncthreads();
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += step) {
    const int ch = (int)(e % c);
    const int64_t pix = e / c;
    const int q = (int)(pix % w);
    const int r = (int)((pix / w) % h);
    const int64_t n = pix / ((int64_t)w * h);
    const int sy = offsets[2 * n], sx = offsets[2 * n + 1];
    const int src_r = r + sy;
    const int src_q = (flip[n] ? w - 1 - q : q) + sx;
    float v = 0.f;
    if (src_r >= 0 && src_r < h && src_q >= 0 && src_q < w)
      v = (float)x[((n * h + src_r) * w + src_q) * c + ch];
    store1(y + e, __fadd_rn(__fmul_rn(v, scale[ch]), shift[ch]));
  }
}

template <typename T>
int launch(const void* x, const void* offsets, const void* flip,
           const void* mean, const void* stdev, void* y, int n, int h, int w,
           int c, void* stream) {
  constexpr int kThreads = 256;
  constexpr int64_t kMaxBlocks = 132 * 16;  // 16 resident blocks per SM
  if (n < 0 || h <= 0 || w <= 0 || c <= 0 || c > 4096)
    return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)n * h * w * c;
  if (total == 0) return (int)cudaGetLastError();
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  pad_crop_kernel<T><<<(unsigned)blocks, kThreads, 2 * c * sizeof(float),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const int*>(offsets),
      static_cast<const uint8_t*>(flip), static_cast<const float*>(mean),
      static_cast<const float*>(stdev), static_cast<T*>(y), total, h, w, c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mcn_pad_crop_u8_f32(const void* x, const void* offsets,
                                   const void* flip, const void* mean,
                                   const void* stdev, void* y, int n, int h,
                                   int w, int c, void* stream) {
  return launch<float>(x, offsets, flip, mean, stdev, y, n, h, w, c, stream);
}

extern "C" int mcn_pad_crop_u8_bf16(const void* x, const void* offsets,
                                    const void* flip, const void* mean,
                                    const void* stdev, void* y, int n, int h,
                                    int w, int c, void* stream) {
  return launch<__nv_bfloat16>(x, offsets, flip, mean, stdev, y, n, h, w, c,
                               stream);
}
