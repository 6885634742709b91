// Fused per-channel scale/shift + activation: y = act(x * a[c] + b[c]).
//
// Replaces the Pallas TPU kernel myconvnet_tpu/ops/pallas/bn_act.py
// (fused_scale_shift_act, and bn_inference_fused through it).  x and y are
// [rows, C] row-major (NHWC activations flattened), f32 or bf16; a and b are
// [C] float32; the math is float32.
//
// What bounds it on the H100: bytes.  It does 2 flops per element against
// 4 (bf16) or 8 (f32) bytes of traffic, far below the ~295 flop/byte where
// the tensor cores would be the limit, so the floor is one read of x and one
// write of y at HBM bandwidth.  The design keeps to that floor: a grid-stride
// loop where each thread moves 16 bytes per load and store (8 bf16 or 4 f32
// values) whenever C is a multiple of that vector width, so a warp reads
// 512 contiguous bytes; a scalar loop covers other channel counts.
//
// The multiply and add are rounded separately (__fmul_rn, __fadd_rn), as
// PyTorch's eager `x * a + b` rounds them, so the kernel matches its plain
// version bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Act { kNone = 0, kRelu = 1, kRelu6 = 2, kLeakyRelu = 3 };

// NaN propagates through every branch, as in jnp.maximum / torch.relu.
__device__ __forceinline__ float activate(float y, int act) {
  switch (act) {
    case kRelu:
      return y < 0.f ? 0.f : y;
    case kRelu6:
      return y < 0.f ? 0.f : (y > 6.f ? 6.f : y);
    case kLeakyRelu:
      return y >= 0.f ? y : 0.2f * y;
    default:
      return y;
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ T apply(T x, float a, float b, int act) {
  return from_float<T>(activate(__fadd_rn(__fmul_rn(to_float(x), a), b), act));
}

// One 16-byte vector per thread per step; requires C % VEC == 0 and 16-byte
// aligned x and y, so a vector never straddles two rows.
template <typename T>
__global__ void scale_shift_act_vec(const T* __restrict__ x,
                                    const float* __restrict__ a,
                                    const float* __restrict__ b,
                                    T* __restrict__ y, int64_t nvec, int c,
                                    int act) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += step) {
    const int ch = (int)((v * VEC) % c);
    uint4 in = reinterpret_cast<const uint4*>(x)[v];
    uint4 out;
    const T* xs = reinterpret_cast<const T*>(&in);
    T* ys = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int i = 0; i < VEC; ++i) ys[i] = apply(xs[i], a[ch + i], b[ch + i], act);
    reinterpret_cast<uint4*>(y)[v] = out;
  }
}

template <typename T>
__global__ void scale_shift_act_scalar(const T* __restrict__ x,
                                       const float* __restrict__ a,
                                       const float* __restrict__ b,
                                       T* __restrict__ y, int64_t total,
                                       int c, int act) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += step) {
    const int ch = (int)(e % c);
    y[e] = apply(x[e], a[ch], b[ch], act);
  }
}

template <typename T>
int launch(const void* x, const void* a, const void* b, void* y, int64_t rows,
           int c, int act, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int kThreads = 256;
  constexpr int64_t kMaxBlocks = 132 * 16;  // 16 resident blocks per SM
  const int64_t total = rows * c;
  if (total == 0) return (int)cudaGetLastError();
  const bool vec = c % VEC == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)y % 16 == 0;
  const int64_t work = vec ? total / VEC : total;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  T* yt = static_cast<T*>(y);
  if (vec) {
    scale_shift_act_vec<T><<<(unsigned)blocks, kThreads, 0, s>>>(
        xt, af, bf, yt, work, c, act);
  } else {
    scale_shift_act_scalar<T><<<(unsigned)blocks, kThreads, 0, s>>>(
        xt, af, bf, yt, work, c, act);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mcn_scale_shift_act_f32(const void* x, const void* a,
                                       const void* b, void* y, int64_t rows,
                                       int c, int act, void* stream) {
  return launch<float>(x, a, b, y, rows, c, act, stream);
}

extern "C" int mcn_scale_shift_act_bf16(const void* x, const void* a,
                                        const void* b, void* y, int64_t rows,
                                        int c, int act, void* stream) {
  return launch<__nv_bfloat16>(x, a, b, y, rows, c, act, stream);
}
