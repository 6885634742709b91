// Correlation (cost) volume of two NHWC feature maps, forward and backward:
//
//   out[n, y, x, dy * nd + dx] =
//       (1 / C) * sum_c f1[n, y, x, c] * f2[n, y + dy - d, x + dx - d, c]
//
// with nd = 2d + 1 and zeros for taps outside the frame; f1, f2 float32 or
// bf16, products and sums in float32, out float32 [N, H, W, nd * nd].
//
// Replaces the Pallas TPU kernel myconvnet_tpu/ops/pallas/correlation.py
// (pallas_correlation_volume, body _corr_fwd_kernel).  That kernel is
// forward-only, walks row tiles with a DMA'd halo of a padded f2 and writes
// [N, K, H, W] for a later transpose, because Mosaic wants full-tile stores.
// None of that carries over: here a block owns TX = 32 neighbouring pixels
// of one output row, stages the (2d + 1) halo rows of f2 around them in
// shared memory (zero-filled outside the frame, so f2 needs no padded
// copy), CC = 16 channels at a time, and writes its [TX, K] outputs, which
// are contiguous in NHWC, in one coalesced sweep.
//
// Forward: warp dy of the block, lane px: the thread keeps the nd sums of
// its pixel for the displacements (dy, 0..nd-1) in registers and reads both
// tiles as float4 over the channels (rows padded to 20 floats, so the eight
// lanes of a 128-bit phase hit eight different bank groups).
//
// Backward, gather form, no atomics (deterministic):
//
//   d_f1[n, y, x, c] = (1 / C) * sum_k g[n, y, x, k] * f2[n, y+dy-d, x+dx-d, c]
//   d_f2[n, y, x, c] = (1 / C) * sum_k g[n, y-dy+d, x-dx+d, k]
//                                      * f1[n, y-dy+d, x-dx+d, c]
//
// Both are one kernel: a weighted sum over the (2d + 1)^2 halo pixels of the
// other feature map.  For d_f1 the weights are the pixel's own K gradients;
// for d_f2 halo pixel (row, col) carries the one gradient channel that
// points back at the output pixel, k = (nd - 1 - row) * nd + (nd - 1 - j).
// Thread (px, q) owns four channels of a pixel (one float4 of the halo tile
// per tap); the gradients are float32 and the result is rounded once to the
// inputs' type.
//
// What bounds it on the H100: with bf16 inputs the bytes do at every recipe
// site (a bf16 product summed in float32 is what the tensor cores compute,
// so their rate sets the operations' bound); with float32 inputs the float32
// output dominates at C = 32 (PWC-Net level 2) and from C = 96 up the
// 2 * N * H * W * K * C float32 operations do.  The kernels multiply on the
// CUDA cores and sit above both (PERF.md): a block issues more instructions staging its tiles than
// multiplying, so the staging loads four channels a thread where C % 4 == 0
// and walks the halo without divisions; after that the shared-memory reads
// of the products (about one 32-bit word per FMA) are the next limit, which
// a thread owning several neighbouring pixels would lift.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;  // output pixels of one row per block
constexpr int CC = 16;  // channels staged per pass
constexpr int CP = 20;  // padded channel stride of the forward's tiles
constexpr int D_MAX = 4;             // largest max_displacement
constexpr int ND_MAX = 2 * D_MAX + 1;  // sums a forward thread keeps

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Four neighbouring channels as float32: one 16-byte (float32) or 8-byte
// (bf16) load, where C is a multiple of 4 and the tensor's base is aligned.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// A "slot" of LP neighbouring threads copies one pixel's values; the
// block's slots walk the halo's (row, col) pixels in order, each slot
// keeping its row and column by addition (no division in the loop).
struct HaloWalk {
  int row, col, lane, slots;
  __device__ __forceinline__ HaloWalk(int cols, int lp)
      : lane(threadIdx.x % lp), slots(blockDim.x / lp) {
    const int pc = threadIdx.x / lp;
    row = pc / cols;
    col = pc - row * cols;
  }
  __device__ __forceinline__ void next(int cols) {
    col += slots;
    while (col >= cols) {
      col -= cols;
      ++row;
    }
  }
};

// One pixel's channels c0..c0+CC-1 of `src` (the pixel's first channel) to
// float32 dst[0..CC), by this slot's threads: four channels a thread when
// VEC (C % 4 == 0, aligned base), else one; zero where !inside or past C.
template <typename T, bool VEC>
__device__ __forceinline__ void stage_pixel(const T* __restrict__ src,
                                            float* __restrict__ dst,
                                            bool inside, int c, int c0,
                                            int lane) {
  if (VEC) {
    const int ch = c0 + 4 * lane;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (inside && ch < c) v = load4(src + ch);
    *reinterpret_cast<float4*>(dst + 4 * lane) = v;
  } else {
    const int ch = c0 + lane;
    dst[lane] = inside && ch < c ? to_f32(src[ch]) : 0.f;
  }
}

// The halo of image `f` ([H, W, C]) around row y and columns x0..x0+TX-1:
// rows y-d..y+d, columns x0-d..x0+TX+d-1, channels c0..c0+CC-1, as float32
// dst[(row * cols + col) * STRIDE + cc], zero outside the frame and past C.
template <typename T, int STRIDE, bool VEC>
__device__ __forceinline__ void stage_halo(const T* __restrict__ f,
                                           float* __restrict__ dst, int h,
                                           int w, int c, int y, int x0, int d,
                                           int c0) {
  const int nd = 2 * d + 1, cols = TX + 2 * d;
  for (HaloWalk at(cols, VEC ? CC / 4 : CC); at.row < nd; at.next(cols)) {
    const int yy = y + at.row - d, xx = x0 + at.col - d;
    const bool inside = yy >= 0 && yy < h && xx >= 0 && xx < w;
    stage_pixel<T, VEC>(f + ((int64_t)yy * w + xx) * c,
                        dst + (at.row * cols + at.col) * STRIDE, inside, c,
                        c0, at.lane);
  }
}

// grid (ceil(W / TX), H, N), block 32 * nd threads, nd <= ND_MAX
template <typename T, bool VEC>
__global__ void corr_fwd_kernel(const T* __restrict__ f1,
                                const T* __restrict__ f2,
                                float* __restrict__ out, int h, int w, int c,
                                int d) {
  extern __shared__ __align__(16) float smem[];
  const int nd = 2 * d + 1, cols = TX + 2 * d, k = nd * nd;
  float* s1 = smem;            // [TX][CP]
  float* s2 = smem + TX * CP;  // [nd][cols][CP]
  const int x0 = blockIdx.x * TX, y = blockIdx.y, n = blockIdx.z;
  const int px = threadIdx.x & 31, dy = threadIdx.x >> 5;
  const T* f1n = f1 + (int64_t)n * h * w * c;
  const T* f2n = f2 + (int64_t)n * h * w * c;
  float acc[ND_MAX];
#pragma unroll
  for (int dx = 0; dx < ND_MAX; ++dx) acc[dx] = 0.f;

  for (int c0 = 0; c0 < c; c0 += CC) {
    constexpr int LP = VEC ? CC / 4 : CC;
    for (int i = threadIdx.x; i < TX * LP; i += blockDim.x) {
      const int p = i / LP, xx = x0 + p;
      stage_pixel<T, VEC>(f1n + ((int64_t)y * w + xx) * c, s1 + p * CP,
                          xx < w, c, c0, i % LP);
    }
    stage_halo<T, CP, VEC>(f2n, s2, h, w, c, y, x0, d, c0);
    __syncthreads();
    const float4* a = reinterpret_cast<const float4*>(s1 + px * CP);
    const float4* b =
        reinterpret_cast<const float4*>(s2 + (dy * cols + px) * CP);
#pragma unroll
    for (int q = 0; q < CC / 4; ++q) {
      const float4 av = a[q];
#pragma unroll
      for (int dx = 0; dx < ND_MAX; ++dx) {
        if (dx < nd) {
          const float4 bv = b[dx * (CP / 4) + q];
          float s = acc[dx];
          s = fmaf(av.x, bv.x, s);
          s = fmaf(av.y, bv.y, s);
          s = fmaf(av.z, bv.z, s);
          s = fmaf(av.w, bv.w, s);
          acc[dx] = s;
        }
      }
    }
    __syncthreads();
  }

  // the block's [TX, K] outputs are contiguous in NHWC: collect them in
  // shared memory (over the f2 tile) and write them in one sweep
  float* so = s2;
  const float count = (float)c;
#pragma unroll
  for (int dx = 0; dx < ND_MAX; ++dx)
    if (dx < nd) so[px * k + dy * nd + dx] = __fdiv_rn(acc[dx], count);
  __syncthreads();
  const int valid = min(TX, w - x0) * k;
  float* o = out + (((int64_t)n * h + y) * w + x0) * k;
  for (int i = threadIdx.x; i < valid; i += blockDim.x) o[i] = so[i];
}

// grid (ceil(W / TX), H, N), block TX * 4 threads: thread (px, q) owns
// channels c0 + 4q .. c0 + 4q + 3 of pixel x0 + px
template <typename T, bool FOR_F2, bool VEC>
__global__ void corr_bwd_kernel(const float* __restrict__ g,
                                const T* __restrict__ f, T* __restrict__ df,
                                int h, int w, int c, int d) {
  extern __shared__ __align__(16) float smem[];
  const int nd = 2 * d + 1, cols = TX + 2 * d, k = nd * nd;
  float* sf = smem;                   // [nd][cols][CC]
  float* sg = smem + nd * cols * CC;  // d_f1: [TX][k]; d_f2: [nd][cols][nd]
  const int x0 = blockIdx.x * TX, y = blockIdx.y, n = blockIdx.z;
  const int px = threadIdx.x >> 2, q = threadIdx.x & 3;
  const float* gn = g + (int64_t)n * h * w * k;
  const T* fn = f + (int64_t)n * h * w * c;
  T* dfn = df + (int64_t)n * h * w * c;

  if (FOR_F2) {
    // halo pixel (row, col): the nd gradient channels of its displacement
    // row nd - 1 - row, the only ones that can point at this block's pixels
    for (HaloWalk at(cols, CC); at.row < nd; at.next(cols)) {
      const int yy = y + at.row - d, xx = x0 + at.col - d;
      if (at.lane < nd) {
        float v = 0.f;
        if (yy >= 0 && yy < h && xx >= 0 && xx < w)
          v = gn[((int64_t)yy * w + xx) * k + (nd - 1 - at.row) * nd +
                 at.lane];
        sg[(at.row * cols + at.col) * nd + at.lane] = v;
      }
    }
  } else {
    const int valid = min(TX, w - x0) * k;
    const float* src = gn + ((int64_t)y * w + x0) * k;
    for (int i = threadIdx.x; i < TX * k; i += blockDim.x)
      sg[i] = i < valid ? src[i] : 0.f;
  }

  const float count = (float)c;
  for (int c0 = 0; c0 < c; c0 += CC) {
    stage_halo<T, CC, VEC>(fn, sf, h, w, c, y, x0, d, c0);
    __syncthreads();  // also orders the gradient tile on the first pass
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int row = 0; row < nd; ++row) {
      for (int j = 0; j < nd; ++j) {
        const int at = row * cols + px + j;
        const float wgt = FOR_F2 ? sg[at * nd + (nd - 1 - j)]
                                 : sg[px * k + row * nd + j];
        const float4 v = *reinterpret_cast<const float4*>(sf + at * CC + 4 * q);
        acc.x = fmaf(wgt, v.x, acc.x);
        acc.y = fmaf(wgt, v.y, acc.y);
        acc.z = fmaf(wgt, v.z, acc.z);
        acc.w = fmaf(wgt, v.w, acc.w);
      }
    }
    const int xx = x0 + px, ch = c0 + 4 * q;
    if (xx < w) {
      T* o = dfn + ((int64_t)y * w + xx) * c + ch;
      if (ch < c) put(o, __fdiv_rn(acc.x, count));
      if (ch + 1 < c) put(o + 1, __fdiv_rn(acc.y, count));
      if (ch + 2 < c) put(o + 2, __fdiv_rn(acc.z, count));
      if (ch + 3 < c) put(o + 3, __fdiv_rn(acc.w, count));
    }
    __syncthreads();
  }
}

// d <= D_MAX: a forward thread keeps ND_MAX sums, and every tile stays
// inside the 48 KB of shared memory a block gets without asking
bool bad_shape(int n, int h, int w, int c, int d) {
  return n < 0 || h < 0 || w < 0 || c < 0 || d < 0 || d > D_MAX ||
         h > 65535 || n > 65535;
}

// four-channel loads need C % 4 == 0 and a base aligned to four elements
template <typename T>
bool vectorizable(int c, const void* p) {
  return c % 4 == 0 && reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

template <typename T>
int launch_fwd(const void* f1, const void* f2, void* out, int n, int h, int w,
               int c, int d, void* stream) {
  if (bad_shape(n, h, w, c, d)) return (int)cudaErrorInvalidValue;
  if ((int64_t)n * h * w == 0) return (int)cudaGetLastError();
  const int nd = 2 * d + 1, cols = TX + 2 * d;
  const size_t bytes = sizeof(float) * (size_t)(TX * CP + nd * cols * CP);
  const dim3 grid((w + TX - 1) / TX, h, n), block(32 * nd);
  const bool vec = vectorizable<T>(c, f1) && vectorizable<T>(c, f2);
  auto kernel = vec ? corr_fwd_kernel<T, true> : corr_fwd_kernel<T, false>;
  kernel<<<grid, block, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<float*>(out), h, w, c, d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* g, const void* f, void* df, int n, int h, int w,
               int c, int d, int for_f2, void* stream) {
  if (bad_shape(n, h, w, c, d)) return (int)cudaErrorInvalidValue;
  if ((int64_t)n * h * w * c == 0) return (int)cudaGetLastError();
  const int nd = 2 * d + 1, cols = TX + 2 * d;
  const size_t tile = for_f2 ? (size_t)nd * cols * nd : (size_t)TX * nd * nd;
  const size_t bytes = sizeof(float) * ((size_t)nd * cols * CC + tile);
  const dim3 grid((w + TX - 1) / TX, h, n), block(TX * 4);
  const bool vec = vectorizable<T>(c, f);
  auto kernel = for_f2 ? (vec ? corr_bwd_kernel<T, true, true>
                              : corr_bwd_kernel<T, true, false>)
                       : (vec ? corr_bwd_kernel<T, false, true>
                              : corr_bwd_kernel<T, false, false>);
  kernel<<<grid, block, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const T*>(f),
      static_cast<T*>(df), h, w, c, d);
  return (int)cudaGetLastError();
}

}  // namespace

// f1, f2 [N, H, W, C], out [N, H, W, (2d + 1)^2] float32, n, h, w, c, d,
// stream
extern "C" int mcn_correlation_fwd_f32(const void* f1, const void* f2,
                                       void* out, int n, int h, int w, int c,
                                       int d, void* stream) {
  return launch_fwd<float>(f1, f2, out, n, h, w, c, d, stream);
}

extern "C" int mcn_correlation_fwd_bf16(const void* f1, const void* f2,
                                        void* out, int n, int h, int w, int c,
                                        int d, void* stream) {
  return launch_fwd<__nv_bfloat16>(f1, f2, out, n, h, w, c, d, stream);
}

// g [N, H, W, (2d + 1)^2] float32, f the OTHER feature map (f2 for d_f1, f1
// for d_f2), df the gradient in f's type, n, h, w, c, d, for_f2, stream
extern "C" int mcn_correlation_bwd_f32(const void* g, const void* f, void* df,
                                       int n, int h, int w, int c, int d,
                                       int for_f2, void* stream) {
  return launch_bwd<float>(g, f, df, n, h, w, c, d, for_f2, stream);
}

extern "C" int mcn_correlation_bwd_bf16(const void* g, const void* f,
                                        void* df, int n, int h, int w, int c,
                                        int d, int for_f2, void* stream) {
  return launch_bwd<__nv_bfloat16>(g, f, df, n, h, w, c, d, for_f2, stream);
}
