// uint8 images to normalized floats in one pass: y = x * scale[c] + shift[c]
// with scale = 1 / (255 * std) and shift = -mean / std.
//
// Replaces the Pallas TPU kernel myconvnet_tpu/ops/pallas/normalize_u8.py
// (normalize_u8).  x is [N, H, W, C] uint8 flattened to [total]; y is the
// same shape in float32 or bf16; mean and std are [C] float32.
//
// What bounds it on the H100: bytes.  It does 2 flops per element against
// 5 (f32 out) or 3 (bf16 out) bytes of traffic, so the floor is one read of
// x and one write of y at HBM bandwidth; at the CIFAR eval batch (393 KB
// in) that floor is 0.6 us, well under a launch's fixed cost, so the
// design also keeps the critical path short:
//
// * a step of a thread is E elements that make one 16-byte store (E = 4
//   f32 or 8 bf16; E = 1 for a base not aligned to E bytes), read by one
//   4- or 8-byte load: neighbouring threads write neighbouring 16 bytes,
//   so each warp's store is 512 contiguous bytes;
// * a one-wave grid from the Python planner (ops/kernels/normalize_u8.py:
//   plan), each thread keeping kUnroll loads in flight before their
//   stores;
// * step k starts at channel (k * E) mod C, and k and k + period start at
//   the same channel (period = C / gcd(C, E)), so thread g takes steps
//   g, g + S, g + 2S, ... with S a multiple of period: its channel of each
//   lane is fixed for life, computed once, and its (scale, shift) pairs
//   sit in registers, worked out without an integer division (FastDiv).
//   No index arithmetic per step or element;
// * the first loads are issued before the fold, which runs while they are
//   in flight: lane l of each warp folds channel l mod C (C <= 32) and
//   every lane takes its pairs by shuffle, so no block waits on a barrier
//   or on shared memory before its first byte arrives.
//
// The fold keeps the plain version's roundings: 1 / (255 * std) as a
// product then a correctly rounded quotient, -mean / std as a correctly
// rounded quotient.  The multiply and add are rounded separately
// (__fmul_rn, __fadd_rn), as PyTorch's eager `x * scale + shift` rounds
// them, so the kernel matches its plain version bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::FastDiv;

constexpr int kThreads = 256;    // threads a block (the planner's THREADS)
constexpr int kMinBlocks = 4;    // blocks an SM the planner counts on
constexpr int kUnroll = 4;       // loads in flight a thread
constexpr int kMaxC = 4096;

__device__ __forceinline__ float2 fold(const float* __restrict__ mean,
                                       const float* __restrict__ stdev,
                                       int c) {
  const float s = __ldg(stdev + c);
  return make_float2(__fdiv_rn(1.f, __fmul_rn(255.f, s)),
                     __fdiv_rn(-__ldg(mean + c), s));
}

__device__ __forceinline__ float norm(uint32_t v, float s, float b) {
  return __fadd_rn(__fmul_rn((float)v, s), b);
}

// the E bytes of a step, loaded as one word
template <int E>
struct Bytes;
template <>
struct Bytes<1> {
  using W = uint8_t;
};
template <>
struct Bytes<4> {
  using W = uint32_t;
};
template <>
struct Bytes<8> {
  using W = unsigned long long;
};

__device__ __forceinline__ uint32_t byte_at(uint64_t w, int i) {
  return (uint32_t)(w >> (8 * i)) & 0xff;
}

// a 16-byte store of the output, streamed (evict first: it is not read
// again here)
__device__ __forceinline__ void put(float4* p, float4 v) { __stcs(p, v); }
__device__ __forceinline__ void put(uint4* p, uint4 v) { __stcs(p, v); }

// step k's E outputs from its bytes w
template <int E>
__device__ __forceinline__ void store(float* y, int64_t k, uint64_t w,
                                      const float* s, const float* b) {
  if constexpr (E == 1) {
    y[k] = norm((uint32_t)w, s[0], b[0]);
  } else {
    static_assert(E == 4, "16 bytes of float32");
    put(reinterpret_cast<float4*>(y) + k,
        make_float4(norm(byte_at(w, 0), s[0], b[0]),
                    norm(byte_at(w, 1), s[1], b[1]),
                    norm(byte_at(w, 2), s[2], b[2]),
                    norm(byte_at(w, 3), s[3], b[3])));
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <int E>
__device__ __forceinline__ void store(__nv_bfloat16* y, int64_t k,
                                      uint64_t w, const float* s,
                                      const float* b) {
  if constexpr (E == 1) {
    y[k] = __float2bfloat16_rn(norm((uint32_t)w, s[0], b[0]));
  } else {
    static_assert(E == 8, "16 bytes of bf16");
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = pack2(norm(byte_at(w, 2 * i), s[2 * i], b[2 * i]),
                   norm(byte_at(w, 2 * i + 1), s[2 * i + 1],
                        b[2 * i + 1]));
    put(reinterpret_cast<uint4*>(y) + k, make_uint4(o[0], o[1], o[2], o[3]));
  }
}

// total / E steps of E elements; thread g takes position p = g mod period
// and the steps (g / period + i * qstep) * period + p, i = 0, 1, ..., where
// qstep = G / period (G threads in the grid, the planner keeps G >=
// period); the last G mod period threads have no step.  Then the < E
// elements past the last step, a thread each.
template <typename T, int E>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    normalize_u8_kernel(const uint8_t* __restrict__ x,
                        const float* __restrict__ mean,
                        const float* __restrict__ stdev, T* __restrict__ y,
                        int64_t total, const FastDiv c,
                        const FastDiv period) {
  using W = typename Bytes<E>::W;
  const W* xw = reinterpret_cast<const W*>(x);
  const int64_t nvec = total / E;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;  // one wave: < 2^31
  const int qstep = period.div(gridDim.x * blockDim.x);
  const int q0 = period.div(g);
  const int p = g - q0 * period.d;
  const int64_t stride = (int64_t)qstep * period.d;
  int64_t k = (int64_t)q0 * period.d + p;
  if (q0 >= qstep) k = nvec;  // idle

  W in[kUnroll];  // the input is read once: streamed loads (evict first)
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (k + u * stride < nvec) in[u] = __ldcs(xw + k + u * stride);

  // the fold, while those loads are in flight: each lane's (scale, shift)
  // of channel (p * E + i) mod C, i < E
  float s[E], b[E];
  int ch = c.mod(p * E);
  if (c.d <= 32) {
    const float2 mine = fold(mean, stdev, c.mod(threadIdx.x & 31));
#pragma unroll
    for (int i = 0; i < E; ++i) {
      s[i] = __shfl_sync(0xffffffffu, mine.x, ch);
      b[i] = __shfl_sync(0xffffffffu, mine.y, ch);
      ch = ch + 1 == c.d ? 0 : ch + 1;
    }
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float2 f = fold(mean, stdev, ch);
      s[i] = f.x;
      b[i] = f.y;
      ch = ch + 1 == c.d ? 0 : ch + 1;
    }
  }

  while (k < nvec) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (k + u * stride < nvec) store<E>(y, k + u * stride, in[u], s, b);
    k += kUnroll * stride;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (k + u * stride < nvec) in[u] = __ldcs(xw + k + u * stride);
  }
  const int64_t e = nvec * E + g;
  if (E > 1 && e < total) {  // total is a multiple of C: count back from it
    const float2 f = fold(mean, stdev, c.mod(c.d - c.mod((int)(total - e))));
    store<1>(y, e, x[e], &f.x, &f.y);
  }
}

template <typename T>
int launch(const void* xp, const void* mean, const void* stdev, void* yp,
           int64_t total, int c, int path, int threads, int blocks,
           void* stream) {
  constexpr int E = 16 / sizeof(T);
  if (total == 0) return (int)cudaGetLastError();
  const uint8_t* x = static_cast<const uint8_t*>(xp);
  T* y = static_cast<T*>(yp);
  const float* m = static_cast<const float*>(mean);
  const float* sd = static_cast<const float*>(stdev);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = path == 1 ? E : 1;
  int gcd = c, r = e;
  while (r) {
    const int t = gcd % r;
    gcd = r;
    r = t;
  }
  const int period = c / gcd;
  if (c <= 0 || c > kMaxC || total % c || (path != 0 && path != 1) ||
      threads != kThreads || blocks < 1 ||
      (int64_t)threads * blocks < period ||
      (int64_t)threads * blocks > 0x7fffffffLL ||
      (path == 1 && ((uintptr_t)x % E || (uintptr_t)y % 16)))
    return (int)cudaErrorInvalidValue;
  const FastDiv cd(c), pd(period);
  if (path == 1)
    normalize_u8_kernel<T, E><<<blocks, threads, 0, s>>>(x, m, sd, y, total,
                                                         cd, pd);
  else
    normalize_u8_kernel<T, 1><<<blocks, threads, 0, s>>>(x, m, sd, y, total,
                                                         cd, pd);
  return (int)cudaGetLastError();
}

}  // namespace

// x, mean, std, y, total elements, C, path (0 an element a step, 1 a
// 16-byte store a step), threads, blocks (ops/kernels/normalize_u8.py's
// planner), stream
extern "C" int mcn_normalize_u8_f32(const void* x, const void* mean,
                                    const void* stdev, void* y, int64_t total,
                                    int c, int path, int threads, int blocks,
                                    void* stream) {
  return launch<float>(x, mean, stdev, y, total, c, path, threads, blocks,
                       stream);
}

extern "C" int mcn_normalize_u8_bf16(const void* x, const void* mean,
                                     const void* stdev, void* y,
                                     int64_t total, int c, int path,
                                     int threads, int blocks, void* stream) {
  return launch<__nv_bfloat16>(x, mean, stdev, y, total, c, path, threads,
                               blocks, stream);
}

// What the Python planner assumes, for the card tests to hold against it.
// out[0..4]: SMs of the current device, blocks of kThreads an SM holds of
// the vector kernel (f32, bf16), kThreads, kUnroll.
extern "C" int mcn_normalize_u8_facts(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[1], normalize_u8_kernel<float, 4>, kThreads, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], normalize_u8_kernel<__nv_bfloat16, 8>, kThreads, 0);
  out[3] = kThreads;
  out[4] = kUnroll;
  return (int)e;
}
