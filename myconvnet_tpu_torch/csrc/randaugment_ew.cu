// One RandAugment layer of elementwise ops over float32 [N, H, W, C]
// images in [0, 1], one op per image: y[n] = op[n](x[n]), the per-image
// statistics included.
//
// Replaces the Pallas TPU kernel myconvnet_tpu/ops/pallas/randaugment_ew.py
// (apply_layer, with _image_stats, which JAX runs as an XLA pass before
// it).  The ops, in PALLAS_POOL's order: identity, autocontrast, invert,
// posterize, solarize, solarize_add, contrast, brightness.  op_idx is [N]
// int64 and the signed magnitude [N] float32, both read on the device (no
// host sync).  C is 1, 3 or 4 (the gray of one channel is JAX's broadcast
// of the three luma weights; of four, the luma of the first three).
//
// What bounds it on the H100: bytes, one read and one write of x (0.368
// ms at [1024, 224, 224, 3]).  Autocontrast needs an image's per-channel
// min and max, contrast its gray mean, before any pixel of that image can
// be written; on the TPU that is a second pass over the batch.  Here:
//
// * one pass (the rule where an image fits a cluster's shared memory): a
//   thread-block cluster of k blocks an image (k in 1, 2, 4, 8, from the
//   Python planner: 8 at 224 x 224 x 3, 73.5 KB a block, three blocks an
//   SM).  Each block brings its contiguous slice (whole pixels, a multiple
//   of 16 bytes) into shared memory with up to eight bulk copies, each
//   completing on its own mbarrier.  Blocks of an image whose op needs the
//   statistics reduce their slice (min, max, float64 sum of lumas),
//   publish the partial in their shared memory, pass a cluster barrier,
//   read all k partials in rank order (distributed shared memory; the same
//   order in every block, no atomics), and arrive on a second cluster
//   barrier that they wait on only before they exit, so that no block
//   leaves while another still reads it.  Then every block applies the op
//   from shared memory and writes its slice once as float4.  The other ops
//   skip both barriers and write each chunk as soon as its copy lands.
// * two passes (images that do not fit, or a slice that cannot be 16-byte
//   aligned): a statistics kernel whose blocks exit at once for an image
//   whose op needs none, the others writing a partial a block to a scratch
//   buffer; then the apply kernel, whose blocks combine an image's
//   partials in a fixed order before they stream their share of it.
//
// The op is dispatched once a block; inside the loops each element costs a
// few operations, and a thread's channel advances by a constant stride
// (no division).
//
// Rounding: each product, sum and quotient is rounded on its own (_rn
// intrinsics, IEEE division), as the plain PyTorch version rounds them:
// nvcc would contract a * b + c into an FMA, and posterize's floor turns
// one ulp into a whole level.  A pixel's luma is rounded to float32 as
// gray() rounds it, the lumas are summed in float64 and the sum divided by
// H * W in float64, rounded once to float32, so the order of the sum does
// not reach the float32 gray mean (the plain version does the same).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;        // every kernel
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 8;        // one pass: bulk copies a block
constexpr int kHeaderBytes = 640;    // one pass: shared memory before a slice
constexpr int kStatsPixels = 2048;   // two passes: pixels a statistics block
constexpr int kMaxApplyBlocks = 64;  // two passes: apply blocks an image

constexpr int kIdentity = 0, kAutocontrast = 1, kInvert = 2, kPosterize = 3,
              kSolarize = 4, kSolarizeAdd = 5, kContrast = 6, kBrightness = 7;

__device__ __forceinline__ bool needs_stats(int op) {
  return op == kAutocontrast || op == kContrast;
}

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.f), 1.f);
}

// Statistics of some pixels as three float4 (48 bytes), so that another
// block of the cluster reads them with ld_cluster_f4: per-channel min,
// per-channel max, the float64 sum of lumas as two 32-bit halves.
struct alignas(16) Rec {
  float4 lo, hi, sum;
};

// gray() of one pixel: 0.299 R + 0.587 G + 0.114 B, each product and sum
// rounded to float32 in that order
template <int C>
__device__ __forceinline__ float luma(const float* v) {
  const float r = v[0], g = v[C >= 3 ? 1 : 0], b = v[C >= 3 ? 2 : 0];
  return __fadd_rn(__fadd_rn(__fmul_rn(r, 0.299f), __fmul_rn(g, 0.587f)),
                   __fmul_rn(b, 0.114f));
}

template <int C>
struct Stats {
  float lo[C], hi[C];
  double sum;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      lo[c] = CUDART_INF_F;
      hi[c] = -CUDART_INF_F;
    }
    sum = 0.0;
  }
  __device__ __forceinline__ void pixel(const float* v) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      lo[c] = fminf(lo[c], v[c]);
      hi[c] = fmaxf(hi[c], v[c]);
    }
    sum += (double)luma<C>(v);
  }
  __device__ __forceinline__ void merge(const Stats& o) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      lo[c] = fminf(lo[c], o.lo[c]);
      hi[c] = fmaxf(hi[c], o.hi[c]);
    }
    sum += o.sum;
  }
  // a butterfly step: both lanes of a pair compute the same sum
  __device__ __forceinline__ void shuffle_xor(int mask) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      lo[c] = fminf(lo[c], __shfl_xor_sync(0xffffffffu, lo[c], mask));
      hi[c] = fmaxf(hi[c], __shfl_xor_sync(0xffffffffu, hi[c], mask));
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, mask);
  }
  __device__ __forceinline__ Rec pack() const {
    float l[4] = {0.f, 0.f, 0.f, 0.f}, h[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < C; ++c) {
      l[c] = lo[c];
      h[c] = hi[c];
    }
    const long long bits = __double_as_longlong(sum);
    Rec r;
    r.lo = make_float4(l[0], l[1], l[2], l[3]);
    r.hi = make_float4(h[0], h[1], h[2], h[3]);
    r.sum = make_float4(__int_as_float((int)(bits & 0xffffffffll)),
                        __int_as_float((int)(bits >> 32)), 0.f, 0.f);
    return r;
  }
  __device__ __forceinline__ static Stats unpack(const Rec& r) {
    const float l[4] = {r.lo.x, r.lo.y, r.lo.z, r.lo.w};
    const float h[4] = {r.hi.x, r.hi.y, r.hi.z, r.hi.w};
    Stats s;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      s.lo[c] = l[c];
      s.hi[c] = h[c];
    }
    const unsigned long long bits =
        (unsigned long long)(unsigned)__float_as_int(r.sum.x) |
        ((unsigned long long)(unsigned)__float_as_int(r.sum.y) << 32);
    s.sum = __longlong_as_double((long long)bits);
    return s;
  }
};

// The block's statistics into *out (thread 0 writes it): a butterfly in
// each warp, then the warps in order; every order is fixed.
template <int C>
__device__ __forceinline__ void block_reduce(Stats<C>& s, Rec* warp_recs,
                                             Rec* out) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s.shuffle_xor(m);
  if (threadIdx.x % 32 == 0) warp_recs[threadIdx.x / 32] = s.pack();
  __syncthreads();
  if (threadIdx.x == 0) {
    Stats<C> t = Stats<C>::unpack(warp_recs[0]);
    for (int w = 1; w < kWarps; ++w) t.merge(Stats<C>::unpack(warp_recs[w]));
    *out = t.pack();
  }
}

// An image's constants, folded once: autocontrast's per-channel lo, 1 /
// max(hi - lo, 1e-5) and hi > lo; contrast's gray mean.
struct Fold {
  float lo[4], scale[4], stretch[4];
  float gray;
};

template <int C>
__device__ __forceinline__ void fold(const Stats<C>& s, int hw, Fold* f) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    f->lo[c] = s.lo[c];
    f->scale[c] = __fdiv_rn(1.f, fmaxf(__fsub_rn(s.hi[c], s.lo[c]), 1e-5f));
    f->stretch[c] = s.hi[c] > s.lo[c] ? 1.f : 0.f;
  }
  f->gray = __double2float_rn(__ddiv_rn(s.sum, (double)hw));
}

// the op's scalars (a, b) from the signed magnitude; contrast's b, the
// gray mean, comes from the statistics
__device__ __forceinline__ float2 op_scalars(int op, float mag) {
  const float m = fabsf(mag);
  switch (op) {
    case kPosterize: {  // the step, a power of two (1 to 16), and 1 / step
      const float levels = exp2f(floorf(__fsub_rn(8.f, __fmul_rn(m, 4.f))));
      const float step = __fdiv_rn(256.f, levels);
      return make_float2(step, __fdiv_rn(1.f, step));
    }
    case kSolarize:  // the threshold
      return make_float2(__fsub_rn(1.f, m), 0.f);
    case kSolarizeAdd:  // the added amount
      return make_float2(__fmul_rn(m, (float)(110.0 / 255.0)), 0.f);
    case kContrast:
    case kBrightness:  // the factor
      return make_float2(__fadd_rn(1.f, __fmul_rn(0.9f, mag)), 0.f);
    default:
      return make_float2(0.f, 0.f);
  }
}

// one element of channel ch; a, b: the op's scalars
template <int OP>
__device__ __forceinline__ float apply(float v, int ch, float a, float b,
                                       const Fold& f) {
  if constexpr (OP == kAutocontrast) {
    return f.stretch[ch] != 0.f
               ? clip01(__fmul_rn(__fsub_rn(v, f.lo[ch]), f.scale[ch]))
               : v;
  } else if constexpr (OP == kInvert) {
    return __fsub_rn(1.f, v);
  } else if constexpr (OP == kPosterize) {
    // x / step as x * (1 / step): both round the same quotient, since the
    // step is a power of two (one IEEE division an element, not two)
    return clip01(__fdiv_rn(
        __fmul_rn(floorf(__fmul_rn(__fmul_rn(v, 255.f), b)), a), 255.f));
  } else if constexpr (OP == kSolarize) {
    return v < a ? v : __fsub_rn(1.f, v);
  } else if constexpr (OP == kSolarizeAdd) {
    return v < 0.5f ? clip01(__fadd_rn(v, a)) : v;
  } else if constexpr (OP == kContrast) {  // b: the gray mean
    return clip01(__fadd_rn(b, __fmul_rn(__fsub_rn(v, b), a)));
  } else if constexpr (OP == kBrightness) {
    return clip01(__fmul_rn(v, a));
  } else {
    return v;
  }
}

// four elements, the first of channel ch
template <int OP, int C>
__device__ __forceinline__ float4 apply4(float4 q, int ch, float a, float b,
                                         const Fold& f) {
  q.x = apply<OP>(q.x, ch, a, b, f);
  q.y = apply<OP>(q.y, (ch + 1) % C, a, b, f);
  q.z = apply<OP>(q.z, (ch + 2) % C, a, b, f);
  q.w = apply<OP>(q.w, (ch + 3) % C, a, b, f);
  return q;
}

// calls f with the op as a compile-time constant (an op outside the pool
// is the identity, as in the plain version's where-chain)
template <typename F>
__device__ __forceinline__ void dispatch(int op, F&& f) {
  switch (op) {
    case kAutocontrast: f(std::integral_constant<int, kAutocontrast>()); break;
    case kInvert: f(std::integral_constant<int, kInvert>()); break;
    case kPosterize: f(std::integral_constant<int, kPosterize>()); break;
    case kSolarize: f(std::integral_constant<int, kSolarize>()); break;
    case kSolarizeAdd: f(std::integral_constant<int, kSolarizeAdd>()); break;
    case kContrast: f(std::integral_constant<int, kContrast>()); break;
    case kBrightness: f(std::integral_constant<int, kBrightness>()); break;
    default: f(std::integral_constant<int, kIdentity>()); break;
  }
}

// ---------------------------------------------------------------- one pass

struct Header {
  uint64_t bar[kMaxChunks];  // one a bulk copy
  Rec part;                  // this block's statistics, read by the cluster
  Rec warp[kWarps];
  Fold fold;
};
static_assert(sizeof(Header) <= kHeaderBytes, "header overflows its room");

// Grid: N * k blocks in clusters of k; block rank r of image n owns the
// floats [r * slice, min((r + 1) * slice, H W C)) of it (whole pixels, a
// multiple of 4 floats).
template <int C>
__global__ void __launch_bounds__(kThreads)
    ra_cluster_kernel(const float* __restrict__ x,
                      const int64_t* __restrict__ op_idx,
                      const float* __restrict__ mag, float* __restrict__ y,
                      int64_t per_image, int hw, int k, int slice) {
  extern __shared__ __align__(128) unsigned char smem[];
  Header& hd = *reinterpret_cast<Header*>(smem);
  float* buf = reinterpret_cast<float*>(smem + kHeaderBytes);
  const int tid = threadIdx.x;
  const int rank = (int)(blockIdx.x % k);
  const int64_t img = blockIdx.x / k;
  const int64_t start = (int64_t)rank * slice;
  const int len =
      (int)min((long long)slice, (long long)(per_image - start));
  const int nvec = len / 4;
  const int cvec = (nvec + kMaxChunks - 1) / kMaxChunks;  // float4s a chunk
  const int chunks = (nvec + cvec - 1) / cvec;
  const float* src = x + img * per_image + start;
  float4* dst = reinterpret_cast<float4*>(y + img * per_image + start);
  if (tid == 0) {
    for (int i = 0; i < chunks; ++i) mbar_init(&hd.bar[i], 1);
    fence_barrier_init();
    for (int i = 0; i < chunks; ++i) {
      const int v0 = i * cvec, bytes = min(cvec, nvec - v0) * 16;
      mbar_expect_tx(&hd.bar[i], (uint32_t)bytes);
      bulk_load(buf + 4 * v0, src + 4 * v0, (uint32_t)bytes, &hd.bar[i]);
    }
  }
  const int op = (int)op_idx[img];
  const float2 ab = op_scalars(op, mag[img]);
  const float a = ab.x;
  float b = ab.y;
  __syncthreads();  // the barriers are initialised
  const bool stats = needs_stats(op);  // the same in every block of the image
  if (stats) {
    for (int i = 0; i < chunks; ++i) mbar_wait(&hd.bar[i], 0);
    Stats<C> s;
    s.init();
    for (int p = tid; p < len / C; p += kThreads) s.pixel(buf + p * C);
    block_reduce(s, hd.warp, &hd.part);
    cluster_arrive();
    cluster_wait();  // every block's partial is in its shared memory
    if (tid == 0) {
      Stats<C> t;
      t.init();
      for (int q = 0; q < k; ++q) {
        Rec r;
        r.lo = ld_cluster_f4(&hd.part.lo, (uint32_t)q);
        r.hi = ld_cluster_f4(&hd.part.hi, (uint32_t)q);
        r.sum = ld_cluster_f4(&hd.part.sum, (uint32_t)q);
        t.merge(Stats<C>::unpack(r));
      }
      fold(t, hw, &hd.fold);
    }
    __syncthreads();
    b = hd.fold.gray;
    cluster_arrive();  // done with the other blocks' shared memory
  }
  const float4* in = reinterpret_cast<const float4*>(buf);
  dispatch(op, [&](auto opc) {
    constexpr int OP = decltype(opc)::value;
    for (int i = 0; i < chunks; ++i) {
      const int v1 = min((i + 1) * cvec, nvec);
      mbar_wait(&hd.bar[i], 0);  // returns at once for a landed copy
      int v = i * cvec + tid;
      int ch = (4 * v) % C;  // the slice starts at a pixel
      for (; v < v1; v += kThreads) {
        dst[v] = apply4<OP, C>(in[v], ch, a, b, hd.fold);
        ch += (4 * kThreads) % C;
        if (ch >= C) ch -= C;
      }
    }
  });
  if (stats) cluster_wait();  // no block leaves while another reads it
}

// -------------------------------------------------------------- two passes

// Grid (statistics blocks an image, N); block b of image n reduces pixels
// [b * kStatsPixels, (b + 1) * kStatsPixels) into part[n * blocks + b].
template <int C>
__global__ void __launch_bounds__(kThreads)
    ra_stats_kernel(const float* __restrict__ x,
                    const int64_t* __restrict__ op_idx, Rec* __restrict__ part,
                    int hw) {
  __shared__ Rec warp_recs[kWarps];
  const int64_t img = blockIdx.y;
  if (!needs_stats((int)op_idx[img])) return;  // the whole block
  const int p0 = blockIdx.x * kStatsPixels;
  const int p1 = min(p0 + kStatsPixels, hw);
  const float* src = x + img * (int64_t)hw * C;
  Stats<C> s;
  s.init();
  for (int p = p0 + threadIdx.x; p < p1; p += kThreads) {
    float v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = __ldg(src + (int64_t)p * C + c);
    s.pixel(v);
  }
  block_reduce(s, warp_recs, part + img * gridDim.x + blockIdx.x);
}

// Grid (apply blocks an image, N): a block combines its image's partials
// (warp 0, lanes over the partials, then a butterfly: a fixed order), then
// streams its share of the image, float4 when VEC.
template <int C, bool VEC>
__global__ void __launch_bounds__(kThreads)
    ra_apply_kernel(const float* __restrict__ x,
                    const int64_t* __restrict__ op_idx,
                    const float* __restrict__ mag, const Rec* __restrict__ part,
                    int stat_blocks, float* __restrict__ y, int64_t per_image,
                    int hw) {
  __shared__ Fold f;
  const int64_t img = blockIdx.y;
  const int op = (int)op_idx[img];
  const float2 ab = op_scalars(op, mag[img]);
  const float a = ab.x;
  float b = ab.y;
  if (needs_stats(op)) {
    if (threadIdx.x < 32) {
      Stats<C> s;
      s.init();
      for (int i = threadIdx.x; i < stat_blocks; i += 32)
        s.merge(Stats<C>::unpack(part[img * stat_blocks + i]));
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) s.shuffle_xor(m);
      if (threadIdx.x == 0) fold(s, hw, &f);
    }
    __syncthreads();
    b = f.gray;
  }
  const float* src = x + img * per_image;
  float* dst = y + img * per_image;
  const int64_t step = (int64_t)gridDim.x * kThreads;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  dispatch(op, [&](auto opc) {
    constexpr int OP = decltype(opc)::value;
    if constexpr (VEC) {
      const int dch = (int)((4 * step) % C);
      int ch = (int)((4 * first) % C);
      for (int64_t v = first; v < per_image / 4; v += step) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(src) + v);
        reinterpret_cast<float4*>(dst)[v] = apply4<OP, C>(q, ch, a, b, f);
        ch += dch;
        if (ch >= C) ch -= C;
      }
    } else {
      const int dch = (int)(step % C);
      int ch = (int)(first % C);
      for (int64_t e = first; e < per_image; e += step) {
        dst[e] = apply<OP>(__ldg(src + e), ch, a, b, f);
        ch += dch;
        if (ch >= C) ch -= C;
      }
    }
  });
}

template <int C>
cudaError_t opt_in() {
  static const cudaError_t err = cudaFuncSetAttribute(
      ra_cluster_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      227 * 1024);
  return err;
}

cudaLaunchConfig_t cluster_config(int n, int k, size_t smem,
                                  cudaLaunchAttribute* attr,
                                  cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n * k), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int C>
int launch(const float* x, const int64_t* op, const float* mag, float* y,
           int n, int hw, int path, int64_t p0, int64_t p1, Rec* scratch,
           cudaStream_t stream) {
  const int64_t per_image = (int64_t)hw * C;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (path == 0) {  // one pass: p0 = k, p1 = slice (floats)
    const int64_t k = p0, slice = p1;
    const size_t smem = kHeaderBytes + (size_t)slice * 4;
    if ((k != 1 && k != 2 && k != 4 && k != 8) || slice <= 0 ||
        slice % 4 != 0 || slice % C != 0 || per_image % 4 != 0 || !aligned ||
        (k - 1) * slice >= per_image || k * slice < per_image ||
        smem > 227 * 1024 || (int64_t)n * k > 0x7fffffff)
      return (int)cudaErrorInvalidValue;
    const DeviceOf on(x);
    if (on.error() != cudaSuccess) return (int)on.error();
    const cudaError_t opted = opt_in<C>();
    if (opted != cudaSuccess) return (int)opted;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        cluster_config(n, (int)k, smem, attr, stream);
    const cudaError_t err =
        cudaLaunchKernelEx(&cfg, ra_cluster_kernel<C>, x, op, mag, y,
                           per_image, hw, (int)k, (int)slice);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  // two passes: p0 = statistics blocks an image, p1 = apply blocks an image
  if (p0 < 1 || p0 * kStatsPixels < hw || (p0 - 1) * kStatsPixels >= hw ||
      p1 < 1 || p1 > kMaxApplyBlocks || n > 65535 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const dim3 sgrid((unsigned)p0, (unsigned)n), agrid((unsigned)p1, (unsigned)n);
  ra_stats_kernel<C><<<sgrid, kThreads, 0, stream>>>(x, op, scratch, hw);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (per_image % 4 == 0 && aligned)
    ra_apply_kernel<C, true><<<agrid, kThreads, 0, stream>>>(
        x, op, mag, scratch, (int)p0, y, per_image, hw);
  else
    ra_apply_kernel<C, false><<<agrid, kThreads, 0, stream>>>(
        x, op, mag, scratch, (int)p0, y, per_image, hw);
  return (int)cudaGetLastError();
}

template <int C>
cudaError_t cluster_facts(int k, int smem, int* out) {
  cudaError_t e = opt_in<C>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], ra_cluster_kernel<C>, kThreads, (size_t)smem);
  if (e == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(1, k, smem, attr, nullptr);
    e = cudaOccupancyMaxActiveClusters(&out[1], ra_cluster_kernel<C>, &cfg);
  }
  return e;
}

}  // namespace

// x, op_idx [N] int64, signed_mag [N] float32, y, n, H * W, c (1, 3 or 4),
// path (0 one pass, 1 two passes), p0, p1 (one pass: blocks a cluster and
// floats a slice; two passes: statistics and apply blocks an image, from
// ops/kernels/randaugment_ew.py's planner), scratch (two passes: 48 bytes
// a statistics block, N * p0 of them), stream
extern "C" int mcn_randaugment_ew_f32(const void* x, const void* op_idx,
                                      const void* mag, void* y, int n,
                                      int hw, int c, int path, int64_t p0,
                                      int64_t p1, void* scratch,
                                      void* stream) {
  if (n == 0 || hw == 0) return (int)cudaGetLastError();
  if (n < 0 || hw < 0 || (path != 0 && path != 1))
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const int64_t* op = static_cast<const int64_t*>(op_idx);
  const float* m = static_cast<const float*>(mag);
  float* yf = static_cast<float*>(y);
  Rec* part = static_cast<Rec*>(scratch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1: return launch<1>(xf, op, m, yf, n, hw, path, p0, p1, part, st);
    case 3: return launch<3>(xf, op, m, yf, n, hw, path, p0, p1, part, st);
    case 4: return launch<4>(xf, op, m, yf, n, hw, path, p0, p1, part, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// What the Python planner copies, for the card tests to hold against it.
// out[0..4]: threads a block, header bytes, pixels a statistics block,
// bytes a partial, apply blocks an image at most; out[5..6] for a cluster
// of k blocks of smem bytes at c channels: blocks an SM holds, clusters
// the card holds at once.
extern "C" int mcn_randaugment_ew_facts(int c, int k, int smem, int* out) {
  out[0] = kThreads;
  out[1] = kHeaderBytes;
  out[2] = kStatsPixels;
  out[3] = (int)sizeof(Rec);
  out[4] = kMaxApplyBlocks;
  switch (c) {
    case 1: return (int)cluster_facts<1>(k, smem, &out[5]);
    case 3: return (int)cluster_facts<3>(k, smem, &out[5]);
    case 4: return (int)cluster_facts<4>(k, smem, &out[5]);
    default: return (int)cudaErrorInvalidValue;
  }
}
