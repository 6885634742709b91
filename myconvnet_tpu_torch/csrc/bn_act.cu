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
// write of y at HBM bandwidth.  At the served ResNet-50's sites (0.24-7.7 us
// of bytes each) a launch's fixed cost is most of the time, so the design
// keeps the grid to one wave and each thread's work free of index math:
//
// * a fixed channel group a thread (the rule where C is a multiple of the
//   16-byte vector, 8 bf16 or 4 f32, and x and y are 16-byte aligned): the
//   Python planner (ops/kernels/bn_act.py) picks threads a block and
//   blocks, at most one wave, so that the grid's stride in vectors is a
//   multiple of C / VEC.  Every vector a thread visits then starts at the
//   same channel: the thread loads its VEC values of a and b once, into
//   registers, and its loop has no modulo.  The loop keeps four 16-byte
//   loads in flight a thread;
// * one channel index a vector (C / VEC above the most threads a block may
//   have: no stride is a multiple), the earlier kernel;
// * one element a step, for a C that is not a multiple of the vector or a
//   base that is not 16-byte aligned.
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

template <typename T>
__device__ __forceinline__ uint4 apply_vec(uint4 in, const float* av,
                                           const float* bv, int act) {
  constexpr int VEC = 16 / sizeof(T);
  uint4 out;
  const T* xs = reinterpret_cast<const T*>(&in);
  T* ys = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int i = 0; i < VEC; ++i) ys[i] = apply(xs[i], av[i], bv[i], act);
  return out;
}

constexpr int kUnroll = 4;  // 16-byte loads in flight a thread

// A fixed channel group a thread: the grid's stride in vectors is a
// multiple of group = C / VEC, so vector v of this thread starts at channel
// (gid % group) * VEC for every v it visits.
template <typename T>
__global__ void scale_shift_act_group(const T* __restrict__ x,
                                      const float* __restrict__ a,
                                      const float* __restrict__ b,
                                      T* __restrict__ y, int64_t nvec,
                                      int group, int act) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int ch = (int)((unsigned)gid % (unsigned)group) * VEC;  // < 2^31
  float av[VEC], bv[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    av[i] = __ldg(a + ch + i);
    bv[i] = __ldg(b + ch + i);
  }
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  int64_t v = gid;
  for (; v + (kUnroll - 1) * stride < nvec; v += kUnroll * stride) {
    uint4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) q[u] = __ldg(xv + v + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      yv[v + u * stride] = apply_vec<T>(q[u], av, bv, act);
  }
  for (; v < nvec; v += stride)
    yv[v] = apply_vec<T>(__ldg(xv + v), av, bv, act);
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
           int c, int act, int path, int threads, int blocks, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t total = rows * c;
  if (total == 0) return (int)cudaGetLastError();
  const bool aligned = (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  if (c <= 0 || act < 0 || act > 3 || path < 0 || path > 2 || threads < 1 ||
      threads > 1024 || blocks < 1 || (path > 0 && (c % VEC || !aligned)) ||
      (path == 2 && ((int64_t)threads * blocks) % (c / VEC) != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  T* yt = static_cast<T*>(y);
  if (path == 2)
    scale_shift_act_group<T><<<blocks, threads, 0, s>>>(
        xt, af, bf, yt, total / VEC, c / VEC, act);
  else if (path == 1)
    scale_shift_act_vec<T><<<blocks, threads, 0, s>>>(xt, af, bf, yt,
                                                      total / VEC, c, act);
  else
    scale_shift_act_scalar<T><<<blocks, threads, 0, s>>>(xt, af, bf, yt,
                                                         total, c, act);
  return (int)cudaGetLastError();
}

}  // namespace

// x, a, b, y, rows, c, act, path (0 scalar, 1 vectors with a channel index
// each, 2 a fixed channel group a thread), threads, blocks (from
// ops/kernels/bn_act.py's planner), stream
extern "C" int mcn_scale_shift_act_f32(const void* x, const void* a,
                                       const void* b, void* y, int64_t rows,
                                       int c, int act, int path, int threads,
                                       int blocks, void* stream) {
  return launch<float>(x, a, b, y, rows, c, act, path, threads, blocks,
                       stream);
}

extern "C" int mcn_scale_shift_act_bf16(const void* x, const void* a,
                                        const void* b, void* y, int64_t rows,
                                        int c, int act, int path, int threads,
                                        int blocks, void* stream) {
  return launch<__nv_bfloat16>(x, a, b, y, rows, c, act, path, threads,
                               blocks, stream);
}

// What the Python planner assumes, for the card tests to hold against it.
// out[0..3]: SMs of the current device, blocks of 256 threads an SM holds
// of the channel-group kernel (f32, bf16), loads in flight a thread.
extern "C" int mcn_scale_shift_act_facts(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[1], scale_shift_act_group<float>, 256, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], scale_shift_act_group<__nv_bfloat16>, 256, 0);
  out[3] = kUnroll;
  return (int)e;
}
