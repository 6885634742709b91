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
// The TPU file rejected the banded-product form below because pulling the
// diagonals out of a product took a lane reduction on the MXU; on Hopper a
// thread knows the (row, column) of each accumulator register, so the band
// is a predicate in the epilogue.
//
// Backward, gather form, no atomics (deterministic):
//
//   d_f1[n, y, x, c] = (1 / C) * sum_k g[n, y, x, k] * f2[n, y+dy-d, x+dx-d, c]
//   d_f2[n, y, x, c] = (1 / C) * sum_k g[n, y-dy+d, x-dx+d, k]
//                                      * f1[n, y-dy+d, x-dx+d, c]
//
// What bounds it on the H100: bytes at every recipe site, the float32
// volume (or its gradient) above all; with bf16 inputs a bf16 product
// summed in float32 is what the tensor cores compute, so their rate sets
// the operations' bound.
//
// Two implementations:
//
// * bf16 with C <= 256 (what the recipes give): the tensor-core kernels
//   below ("tensor-core path"), where each output row x 64 pixels is, for
//   each displacement row, one banded matrix product on wgmma.
// * float32, and bf16 with C > 256: CUDA-core kernels.  No recipe gives the
//   kernels float32, and its tolerance (2^-18 of the largest value) is
//   below what bf16 products can meet.  A block owns TX = 32 neighbouring
//   pixels of one output row, stages the (2d + 1) halo rows around them in
//   shared memory (zero-filled outside the frame), CC = 16 channels at a
//   time.  Forward: warp dy, lane px keeps the nd sums of its pixel in
//   registers and reads both tiles as float4 over the channels (rows padded
//   to 20 floats: the eight lanes of a 128-bit phase hit eight bank
//   groups).  Backward: one kernel for both gradients, a weighted sum over
//   the (2d + 1)^2 halo pixels of the other map; d_f1's weights are the
//   pixel's own K gradients, d_f2's halo pixel (row, col) carries the one
//   gradient channel that points back at it, k = (nd - 1 - row) * nd +
//   (nd - 1 - j); thread (px, q) owns four channels of a pixel.  Products
//   run at about one shared-memory word an FMA.

#include "hopper.cuh"

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


// ------------------------------------------------ tensor-core path (bf16)
//
// Block: one consumer warpgroup (threads 0-127: wgmma, epilogue) and one
// producer warp (128-159: loads); two or three blocks an SM where shared
// memory and registers allow, since a lone warpgroup waits out every
// wgmma's and every load's latency.  The block owns image n, output rows
// y0 .. y0 + ty - 1 and pixels x0 .. x0 + 63.  Its operands live in two
// rings of shared memory, each slot with a "full" and an "empty" mbarrier:
//
// * the segment ring: rows of the other feature map, pixels x0 - d ..
//   x0 - d + SEG - 1 (SEG >= min(64, W) + 2d), every channel, as KC SW128
//   panels of SEG rows x 64 channels.  TMA's zero fill is the zero padding
//   and the channel tail; where TMA cannot describe the map (C % 8 != 0, a
//   base not 16-byte aligned) the producer copies the pixels inside the
//   frame into the same layout (8-byte cp.async, or plain loads) over
//   slots zeroed once.  With `reuse`, load i is row y0 - d + i, loaded once
//   and kept for the nd output rows it serves; else load t nd + e is row
//   y0 + t - d + e, one for every pair (the planner takes whichever gives
//   more blocks an SM);
// * the aux ring: the forward's f1 row (KC panels of 64 x 64), d_f1's
//   gradient rows [64][K] float32 of the output row (one bulk copy), or
//   d_f2's gradient piece [SEG][nd] float32 (the nd channels of one
//   displacement row at the segment's pixels, 36-byte pieces by 4-byte
//   cp.async), one for every pair.
//
// Pair (t, e) of output row y = y0 + t:
//   forward  S = F1[y] F2seg[y + e - d]^T (m64 nSEG, K = channels);
//            out[y, x0 + r, e nd + dx] = S[r, r + dx] / C for dx <= 2d,
//            gathered in a [64][89] tile and stored row by row;
//   d_f1     acc += G F2seg[y + e - d]   with G[r, j] = g[y, x0 + r,
//            e nd + j - r] on the band 0 <= j - r <= 2d (A from registers,
//            B MN-major: the segment's panels read with the transpose bit);
//   d_f2     acc += G' F1seg[y - d + e]  with dy = 2d - e and G'[r, j] =
//            g[y - d + e, x0 - d + j, dy nd + 2d - (j - r)] on the band.
// g is float32: A = hi + lo, both bf16, two products into one float32 sum
// (g to about 2^-16; one bf16 copy of g would miss the gradients' 2 bf16
// ulps).  The band costs products: a 64-row tile meets the band in 2 of
// its 5 k-steps a warp, 9 of 72 columns.  The channel mean divides by C
// with __fdiv_rn (a product by 1 / C where C is a power of two, which
// rounds the same).

constexpr int kM = 64;         // output pixels of a tile (wgmma's rows)
// Segment pixels: at least min(64, W) + 2d, the forward's a wgmma width
// (n16, n40, n72), the backward's whole k-steps of 16 (1, 3, 5); narrow
// maps (PWC-Net's levels 4-6) take the short ones
constexpr int kSegMax = 80;
__host__ __device__ constexpr bool seg_ok(int mode, int seg) {
  return mode == 0 ? seg == 16 || seg == 40 || seg == 72
                   : seg == 16 || seg == 48 || seg == 80;
}
constexpr int kPanel = 128;    // bytes of a 64-channel row (SW128)
// Panels are 64 channels, or 32 (64-byte rows, SW64) where C <= 32 comes
// by TMA: PWC-Net's level 2 (C = 32) then moves, stages and multiplies no
// zero half.
constexpr int kTcThreads = 160;  // a consumer warpgroup and a producer warp
constexpr int kKcMax = 4;      // 64-channel panels: C <= 256
constexpr int kSmemMax = 232448;
constexpr int kOutStride = 89;  // floats between the output tile's rows

enum Mode { kFwd = 0, kBwdF1 = 1, kBwdF2 = 2 };

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Shared-memory layout (bytes from a 1024-aligned base); `total` includes
// the 1024 bytes that align the base.  ops/kernels/correlation.py copies it.
struct TcLayout {
  int seg_bytes, aux_bytes, aux_off, out_off, bar_off, total;
  __host__ __device__ TcLayout(int mode, int kc, int d, int seg, int pw,
                               int slots, int aux_slots) {
    const int nd = 2 * d + 1, k = nd * nd;
    seg_bytes = kc * seg * pw * 2;
    aux_bytes = mode == kFwd     ? kc * kM * pw * 2
                : mode == kBwdF1 ? round_up(kM * k * 4, 1024)
                                 : round_up(kSegMax * nd * 4, 1024);
    aux_off = slots * seg_bytes;
    out_off = aux_off + aux_slots * aux_bytes;
    bar_off = out_off + (mode == kFwd ? kM * kOutStride * 4 : 0);
    total = bar_off + 16 * (slots + aux_slots) + 1024;
  }
};

struct TcArgs {
  const __nv_bfloat16* a;    // forward: f1 (the A rows)
  const __nv_bfloat16* seg;  // segments: f2 (forward, d_f1) or f1 (d_f2)
  const float* g;            // backward: the volume's gradient
  float* out;                // forward: the volume
  __nv_bfloat16* df;         // backward: the gradient
  int n, h, w, c, d, ty, slots, aux_slots, reuse, tma, tiles_x, tiles_y;
};

// KC panels of `rows` pixels (px0 ..) x 64 channels of row `row` of image
// n into the SW128 layout TMA writes (zero outside the frame and past C),
// by the producer warp, completing on `bar`: 8-byte cp.async copies (four
// channels) where C % 4 == 0 and the base is 8-byte aligned, else plain
// loads.  The consumers fence the async proxy after their wait.
template <int KC>
__device__ __forceinline__ void stage_plain(uint8_t* dst,
                                            const __nv_bfloat16* f,
                                            const TcArgs& p, int n, int row,
                                            int px0, int rows, int pt,
                                            uint64_t* bar) {
  const bool row_in = row >= 0 && row < p.h;
  const __nv_bfloat16* frow = f + ((int64_t)n * p.h + (row_in ? row : 0)) *
                                      p.w * p.c;
  if (p.c % 4 == 0 && reinterpret_cast<uintptr_t>(f) % 8 == 0) {
    // 8-byte copies of four channels at the pixels inside the frame (zeros
    // for a row outside it); the slot is zero elsewhere from the start
    const int xa = max(px0, 0), npx = max(0, min(px0 + rows, p.w) - xa);
    const int nh = p.c / 4;
    for (int idx = pt; idx < npx * nh; idx += 32) {
      const int pxi = idx / nh, ch0 = 4 * (idx - pxi * nh);
      const int x = xa + pxi, px = x - px0;
      const int kc = ch0 >> 6, c8 = (ch0 >> 3) & 7, half = (ch0 >> 2) & 1;
      uint8_t* at = dst + kc * rows * kPanel + px * kPanel +
                    ((c8 ^ (px & 7)) << 4) + half * 8;
      if (row_in)
        hopper::cp_async_8(at, frow + (int64_t)x * p.c + ch0, 8);
      else
        *reinterpret_cast<uint2*>(at) = make_uint2(0u, 0u);
    }
    hopper::fence_proxy_async();
    hopper::cp_async_arrive(bar);
  } else {
    for (int idx = pt; idx < KC * rows * 8; idx += 32) {
      const int kc = idx / (rows * 8), rem = idx - kc * rows * 8;
      const int px = rem >> 3, c8 = rem & 7;
      const int x = px0 + px, ch0 = kc * 64 + c8 * 8;
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (row_in && x >= 0 && x < p.w) {
        const __nv_bfloat16* src = frow + (int64_t)x * p.c;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (ch0 + i < p.c)
            v[i >> 1] |= (uint32_t)__bfloat16_as_ushort(src[ch0 + i])
                         << (16 * (i & 1));
      }
      *reinterpret_cast<uint4*>(dst + kc * rows * kPanel + px * kPanel +
                                ((c8 ^ (px & 7)) << 4)) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
    hopper::fence_proxy_async();
  }
  __syncwarp();
  if (pt == 0) hopper::mbar_arrive(bar);
}

// A fragment (hi and lo bf16 halves) of the banded gradient for k-step kk:
// src[index(row, j, dx)] is the float32 entry inside the band, zero outside
// it (every lane loads, index 0 outside the band, and selects: no branch)
template <typename F>
__device__ __forceinline__ void band_fragment(uint32_t (&hi)[4],
                                              uint32_t (&lo)[4], int kk,
                                              int r0, int tq, int d,
                                              const float* src, F index) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + 8 * (r & 1);
    const int j0 = 16 * kk + 8 * (r >> 1) + 2 * tq;
    float v[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int dx = j0 + q - row;
      const bool in = (unsigned)dx <= (unsigned)(2 * d);
      const float x = src[in ? index(row, j0 + q, dx) : 0];
      v[q] = in ? x : 0.f;
    }
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(v[0], v[1]);
    const float2 hf = __bfloat1622float2(h2);
    hi[r] = *reinterpret_cast<const uint32_t*>(&h2);
    lo[r] = hopper::pack_bf16x2(v[0] - hf.x, v[1] - hf.y);
  }
}

// The forward's band into the output tile (rows kOutStride floats apart:
// 2-way bank conflicts at most, 4-way at 81): column r + dx of row r is
// displacement dx of the pair's row, channel `at` + dx.  Warp w's rows 16w
// .. 16w + 15 reach columns 16w .. 16w + 23 only, chunks 2w .. 2w + 2 of
// the accumulator; W is the warp as a template argument, which keeps the
// register indices static.
template <int W, int N>
__device__ __forceinline__ void band_chunks(float* outs,
                                            const float (&acc)[N / 2], int r0,
                                            int tq, int d, int at) {
#pragma unroll
  for (int jc = 2 * W; jc < 2 * W + 3 && jc < N / 8; ++jc)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int row = r0 + 8 * hh;
        const int dx = 8 * jc + 2 * tq + q - row;
        if ((unsigned)dx <= (unsigned)(2 * d))
          outs[row * kOutStride + at + dx] = acc[4 * jc + 2 * hh + q];
      }
}

template <int N>
__device__ __forceinline__ void band_to_tile(float* outs,
                                             const float (&acc)[N / 2],
                                             int warp, int r0, int tq, int d,
                                             int at) {
  switch (warp) {
    case 0: band_chunks<0, N>(outs, acc, r0, tq, d, at); break;
    case 1: band_chunks<1, N>(outs, acc, r0, tq, d, at); break;
    case 2: band_chunks<2, N>(outs, acc, r0, tq, d, at); break;
    default: band_chunks<3, N>(outs, acc, r0, tq, d, at); break;
  }
}

// Blocks an SM the launch bounds ask registers for: three of the forward
// (36 accumulators), of d_f1 and d_f2 as their KC x 32 accumulators allow
template <int MODE, int KC>
constexpr int kMinBlocks = MODE == kFwd ? 3 : KC == 1 ? 3 : KC <= 3 ? 2 : 1;

template <int MODE, int KC, int SEG, int PW>
__global__ void __launch_bounds__(kTcThreads, kMinBlocks<MODE, KC>)
    corr_tc_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_seg,
                   const TcArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const TcLayout L(MODE, KC, p.d, SEG, PW, p.slots, p.aux_slots);
  constexpr int PB = PW * 2;  // bytes of a panel's row
  uint8_t* seg = smem;
  uint8_t* aux = smem + L.aux_off;
  float* outs = reinterpret_cast<float*>(smem + L.out_off);
  uint64_t* seg_full = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  uint64_t* seg_empty = seg_full + p.slots;
  uint64_t* aux_full = seg_empty + p.slots;
  uint64_t* aux_empty = aux_full + p.aux_slots;

  const int d = p.d, nd = 2 * d + 1, k = nd * nd;
  const int segrows = SEG;
  const int tile_x = blockIdx.x % p.tiles_x;
  const int rest = blockIdx.x / p.tiles_x;
  const int tile_y = rest % p.tiles_y, n = rest / p.tiles_y;
  const int x0 = tile_x * kM, y0 = tile_y * p.ty;
  const int rows = min(p.ty, p.h - y0);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < p.slots; ++s) {
      hopper::mbar_init(&seg_full[s], 1);
      hopper::mbar_init(&seg_empty[s], 128);
    }
    for (int s = 0; s < p.aux_slots; ++s) {
      hopper::mbar_init(&aux_full[s], 1);
      hopper::mbar_init(&aux_empty[s], 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 128) {
    // ---------------------------------------------------------- producer
    const int pt = tid - 128;
    // Loads that are not TMA's write only what lies inside the frame and
    // the channels: the rest of every slot (the pixels left and right of
    // the map, the channels past C) is zero from here on, once a block
    if (!p.tma || MODE == kBwdF2) {
      for (int i = pt; i < L.bar_off / 16; i += 32)
        reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
      hopper::fence_proxy_async();
    }
    auto seg_load = [&](int i) {
      const int s = i % p.slots;
      const int row = p.reuse ? y0 - d + i : y0 + i / nd - d + i % nd;
      hopper::mbar_wait(&seg_empty[s], ((i / p.slots) & 1) ^ 1);
      uint8_t* dst = seg + s * L.seg_bytes;
      if (p.tma) {
        if (pt == 0) {
          hopper::mbar_expect_tx(&seg_full[s], L.seg_bytes);
#pragma unroll
          for (int kc = 0; kc < KC; ++kc)
            hopper::tma_load_4d(dst + kc * segrows * PB, &map_seg,
                                &seg_full[s], PW * kc, x0 - d, row, n);
        }
      } else {
        stage_plain<KC>(dst, p.seg, p, n, row, x0 - d, segrows, pt,
                        &seg_full[s]);
      }
    };
    // the aux load of row t (forward, d_f1) or of pair (t, e) (d_f2)
    auto aux_load = [&](int t, int e) {
      const int i = MODE == kBwdF2 ? t * nd + e : t;
      const int s = i % p.aux_slots;
      hopper::mbar_wait(&aux_empty[s], ((i / p.aux_slots) & 1) ^ 1);
      uint8_t* dst = aux + s * L.aux_bytes;
      const int y = y0 + t;
      if (MODE == kFwd) {
        if (p.tma) {
          if (pt == 0) {
            hopper::mbar_expect_tx(&aux_full[s], L.aux_bytes);
#pragma unroll
            for (int kc = 0; kc < KC; ++kc)
              hopper::tma_load_4d(dst + kc * kM * PB, &map_a,
                                  &aux_full[s], PW * kc, x0, y, n);
          }
        } else {
          stage_plain<KC>(dst, p.a, p, n, y, x0, kM, pt, &aux_full[s]);
        }
        return;
      }
      float* fd = reinterpret_cast<float*>(dst);
      if (MODE == kBwdF1) {
        // the output row's gradients, contiguous: one bulk copy where its
        // start and length allow, else 4-byte copies
        const int vp = min(kM, p.w - x0);
        const float* src = p.g + (((int64_t)n * p.h + y) * p.w + x0) * k;
        const uint32_t bytes = (uint32_t)vp * k * 4;
        if (bytes % 16 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
          if (pt == 0) {
            hopper::mbar_expect_tx(&aux_full[s], bytes);
            hopper::bulk_load(fd, src, bytes, &aux_full[s]);
          }
          return;
        }
        for (int i2 = pt; i2 < vp * k; i2 += 32)
          hopper::cp_async_4(fd + i2, src + i2, 4);
      } else {
        // pair (t, e): row y - d + e, displacement row dy = 2d - e, the nd
        // gradients of pixels x0 - d .. x0 + 63 + d (pixels outside the
        // map stay zero from the start); lane (jl, q): channel q of pixels
        // jl, jl + per, ... (per pixels of nd channels a pass of the warp)
        const int row = y - d + e, dy = 2 * d - e;
        const bool row_in = row >= 0 && row < p.h;
        const float* src = p.g + ((int64_t)n * p.h + (row_in ? row : 0)) *
                                     p.w * k + dy * nd;
        const int per = 32 / nd, jl = pt / nd, q = pt - jl * nd;
        const int ja = max(0, d - x0), jb = min(kM + 2 * d, p.w - x0 + d);
        if (jl < per)
          for (int j = ja + jl; j < jb; j += per) {
            const int x = x0 - d + j;
            hopper::cp_async_4(fd + j * nd + q,
                               row_in ? src + (int64_t)x * k + q : src,
                               row_in ? 4 : 0);
          }
      }
      hopper::cp_async_arrive(&aux_full[s]);
      __syncwarp();
      if (pt == 0) hopper::mbar_arrive(&aux_full[s]);
    };
    for (int t = 0; t < rows; ++t) {
      if (MODE != kBwdF2) aux_load(t, 0);
      if (p.reuse) {
        for (int i = t == 0 ? 0 : t + 2 * d; i <= t + 2 * d; ++i) seg_load(i);
        if (MODE == kBwdF2)
          for (int e = 0; e < nd; ++e) aux_load(t, e);
      } else {
        for (int e = 0; e < nd; ++e) {
          seg_load(t * nd + e);
          if (MODE == kBwdF2) aux_load(t, e);
        }
      }
    }
    hopper::cp_async_wait_all();
    return;
  }

  // ------------------------------------------------------------ consumer
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2), tq = lane & 3;
  // x / C as __fdiv_rn rounds it; where C is a power of two that is the
  // product by 1 / C, exactly
  const float count = (float)p.c, inv = 1.f / count;
  const bool pow2 = (p.c & (p.c - 1)) == 0;
  auto mean = [&](float v) { return pow2 ? v * inv : __fdiv_rn(v, count); };
  for (int t = 0; t < rows; ++t) {
    const int y = y0 + t;
    const int as = t % p.aux_slots;
    const int vp = min(kM, p.w - x0);
    if (MODE != kBwdF2)
      hopper::mbar_wait(&aux_full[as], (t / p.aux_slots) & 1);
    hopper::fence_proxy_async();  // rows staged by cp.async or plain loads
    // the backward's sums start at pair 0 with scale_d = 0 (zeroing them
    // by plain writes made ptxas serialize the wgmmas, C7520)
    float acc[MODE == kFwd ? 1 : KC][MODE == kFwd ? SEG / 2 : PW / 2];
    for (int e = 0; e < nd; ++e) {
      // the segment of pair (t, e): with `reuse` row y0 - d + t + e, kept
      // for the next rows; else a load of its own
      const int li = p.reuse ? t + e : t * nd + e;
      const int s = li % p.slots;
      if constexpr (MODE == kFwd) {
        hopper::mbar_wait(&seg_full[s], (li / p.slots) & 1);
        hopper::fence_proxy_async();
        const uint32_t seg_addr = hopper::smem_addr(seg + s * L.seg_bytes);
        const uint32_t a_addr = hopper::smem_addr(aux + as * L.aux_bytes);
        hopper::wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < KC; ++kc)
#pragma unroll
          for (int kk = 0; kk < PW / 16; ++kk) {
            const uint32_t ao = a_addr + kc * kM * PB + kk * 32;
            const uint32_t bo = seg_addr + kc * SEG * PB + kk * 32;
            hopper::wgmma_ss(
                acc[0], PW == 64 ? hopper::desc_sw128(ao) : hopper::desc_sw64(ao),
                PW == 64 ? hopper::desc_sw128(bo) : hopper::desc_sw64(bo),
                (kc | kk) != 0);
          }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        if (!p.reuse) hopper::mbar_arrive(&seg_empty[s]);
        band_to_tile<SEG>(outs, acc[0], warp, r0, tq, d, e * nd);
      } else {
        // A fragments: warp w's rows 16w .. 16w + 15 meet the band only in
        // k-steps w and w + 1; those two are built and the others are
        // zeros, all before the fence (a register of a wgmma's A written
        // after it, or on a path that the warps of the warpgroup do not
        // all take, makes ptxas serialize the wgmmas: C7519, C7520)
        // every wait comes before the fragments: a register of a wgmma's A
        // set after a wait's polling loop made ptxas serialize (C7520)
        hopper::mbar_wait(&seg_full[s], (li / p.slots) & 1);
        hopper::fence_proxy_async();
        uint32_t two_hi[2][4], two_lo[2][4];
        if constexpr (MODE == kBwdF1) {
          const float* gt =
              reinterpret_cast<const float*>(aux + as * L.aux_bytes);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            band_fragment(two_hi[h2], two_lo[h2], warp + h2, r0, tq, d, gt,
                          [&](int row, int, int dx) {
                            return row * k + e * nd + dx;
                          });
        } else {
          const int pi = t * nd + e, ps = pi % p.aux_slots;
          hopper::mbar_wait(&aux_full[ps], (pi / p.aux_slots) & 1);
          __syncwarp();
          const float* pc =
              reinterpret_cast<const float*>(aux + ps * L.aux_bytes);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            band_fragment(two_hi[h2], two_lo[h2], warp + h2, r0, tq, d, pc,
                          [&](int, int j, int dx) {
                            return j * nd + 2 * d - dx;
                          });
          hopper::mbar_arrive(&aux_empty[ps]);
        }
        constexpr int KS = SEG / 16;  // k-steps of the segment's pixels
        uint32_t hi[KS][4], lo[KS][4];
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            hi[kk][r] = kk == warp       ? two_hi[0][r]
                        : kk == warp + 1 ? two_hi[1][r]
                                         : 0u;
            lo[kk][r] = kk == warp       ? two_lo[0][r]
                        : kk == warp + 1 ? two_lo[1][r]
                                         : 0u;
          }
        const uint32_t seg_addr = hopper::smem_addr(seg + s * L.seg_bytes);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
#pragma unroll
          for (int kc = 0; kc < KC; ++kc) {
            const uint32_t bo = seg_addr + kc * SEG * PB + kk * 16 * PB;
            const uint64_t db =
                PW == 64 ? hopper::desc_sw128(bo) : hopper::desc_sw64(bo);
            hopper::wgmma_rs_tb(acc[kc], hi[kk], db, (e | kk) != 0);
            hopper::wgmma_rs_tb(acc[kc], lo[kk], db, 1);
          }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        if (!p.reuse) hopper::mbar_arrive(&seg_empty[s]);
      }
    }
    if (MODE != kBwdF2) hopper::mbar_arrive(&aux_empty[as]);
    if (p.reuse) hopper::mbar_arrive(&seg_empty[t % p.slots]);
    if constexpr (MODE == kFwd) {
      // the tile's [vp, K] outputs are contiguous in NHWC: coalesced
      // stores, the channel mean on the way; (r, c) walks the padded rows
      hopper::named_barrier(1, 128);
      const int64_t base = (((int64_t)n * p.h + y) * p.w + x0) * k;
      const int total = vp * k;
      if (((base | total) & 3) == 0) {
        // float4 stores of four consecutive outputs (one pixel's or two)
        float4* o = reinterpret_cast<float4*>(p.out + base);
        int r = 4 * tid / k, c = 4 * tid - r * k;
        for (int i = tid; i < total / 4; i += 128) {
          float v[4];
          for (int j = 0, rr = r, cc = c; j < 4; ++j) {
            v[j] = mean(outs[rr * kOutStride + cc]);
            if (++cc == k) cc = 0, ++rr;
          }
          o[i] = make_float4(v[0], v[1], v[2], v[3]);
          for (c += 512; c >= k; c -= k) ++r;
        }
      } else {
        float* o = p.out + base;
        int r = tid / k, c = tid - r * k;
        for (int i = tid; i < total; i += 128) {
          o[i] = mean(outs[r * kOutStride + c]);
          for (c += 128; c >= k; c -= k) ++r;
        }
      }
      hopper::named_barrier(1, 128);
    } else {
      __nv_bfloat16* o = p.df + (((int64_t)n * p.h + y) * p.w + x0) * p.c;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
#pragma unroll
        for (int jc = 0; jc < PW / 8; ++jc)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = r0 + 8 * hh;
            const int ch = PW * kc + 8 * jc + 2 * tq;
            if (row >= vp || ch >= p.c) continue;
            const float v0 = mean(acc[kc][4 * jc + 2 * hh]);
            const float v1 = mean(acc[kc][4 * jc + 2 * hh + 1]);
            __nv_bfloat16* at = o + (int64_t)row * p.c + ch;
            if (ch + 1 < p.c && (p.c & 1) == 0) {
              *reinterpret_cast<__nv_bfloat162*>(at) =
                  __floats2bfloat162_rn(v0, v1);
            } else {
              at[0] = __float2bfloat16_rn(v0);
              if (ch + 1 < p.c) at[1] = __float2bfloat16_rn(v1);
            }
          }
    }
  }
}

template <int MODE, int KC, int SEG, int PW>
cudaError_t tc_opt_in() {
  static const cudaError_t err = cudaFuncSetAttribute(
      corr_tc_kernel<MODE, KC, SEG, PW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  return err;
}

// Calls f.template operator()<MODE, KC, SEG, PW>() for the instance that
// takes (kc, seg, pw); seg_ok(MODE, seg) has been checked, and pw is 32
// only with kc 1.
template <int MODE, int KC, int PW, typename F>
int with_seg(int seg, F f) {
  constexpr int s0 = 16, s1 = MODE == kFwd ? 40 : 48,
                s2 = MODE == kFwd ? 72 : 80;
  return seg == s0   ? f.template operator()<MODE, KC, s0, PW>()
         : seg == s1 ? f.template operator()<MODE, KC, s1, PW>()
                     : f.template operator()<MODE, KC, s2, PW>();
}

template <int MODE, typename F>
int with_instance(int kc, int seg, int pw, F f) {
  switch (kc) {
    case 1:
      return pw == 32 ? with_seg<MODE, 1, 32>(seg, f)
                      : with_seg<MODE, 1, 64>(seg, f);
    case 2: return with_seg<MODE, 2, 64>(seg, f);
    case 3: return with_seg<MODE, 3, 64>(seg, f);
    default: return with_seg<MODE, 4, 64>(seg, f);
  }
}

template <typename F>
int with_instance(int mode, int kc, int seg, int pw, F f) {
  return mode == kFwd     ? with_instance<kFwd>(kc, seg, pw, f)
         : mode == kBwdF1 ? with_instance<kBwdF1>(kc, seg, pw, f)
                          : with_instance<kBwdF2>(kc, seg, pw, f);
}

struct TcLaunch {
  const CUtensorMap *ma, *ms;
  const TcArgs* args;
  unsigned blocks;
  int smem;
  cudaStream_t st;
  template <int M, int K, int S, int P>
  int operator()() const {
    const cudaError_t e = tc_opt_in<M, K, S, P>();
    if (e != cudaSuccess) return (int)e;
    corr_tc_kernel<M, K, S, P><<<blocks, kTcThreads, smem, st>>>(*ma, *ms,
                                                                 *args);
    return (int)cudaGetLastError();
  }
};

// blocks of the instance an SM holds at `smem` bytes
struct TcOccupancy {
  int* blocks;
  int smem;
  template <int M, int K, int S, int P>
  int operator()() const {
    cudaError_t e = tc_opt_in<M, K, S, P>();
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, corr_tc_kernel<M, K, S, P>, kTcThreads, smem);
    return (int)e;
  }
};

// the [N, H, W, C] bf16 map whose box is pw (64 or 32) channels x `pixels`
// of one row, swizzled as the panels are (128 or 64 bytes)
bool feature_map(CUtensorMap* map, const void* f, int n, int h, int w, int c,
                 int pixels, int pw) {
  const uint64_t dims[4] = {(uint64_t)c, (uint64_t)w, (uint64_t)h,
                            (uint64_t)n};
  const uint64_t strides[3] = {(uint64_t)c * 2, (uint64_t)w * c * 2,
                               (uint64_t)h * w * c * 2};
  const uint32_t box[4] = {(uint32_t)pw, (uint32_t)pixels, 1, 1};
  return hopper::encode_tiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      pw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B, f, 4,
      dims, strides, box);
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

// The tensor-core kernels (bf16, C <= 256).  mode 0: the forward (a = f1,
// seg = f2, dst = the float32 volume); 1: d_f1 (seg = f2, dst = d_f1); 2:
// d_f2 (seg = f1, dst = d_f2); g the volume's gradient (backward).  segrows,
// pw (panel channels, 32 only by TMA at C <= 32), ty, slots, aux_slots,
// reuse: ops/kernels/correlation.py's plan; tma: 1 for TMA loads (C % 8 ==
// 0, 16-byte aligned bases), 0 for the producer's copies.
extern "C" int mcn_correlation_tc(int mode, const void* a, const void* seg,
                                  const void* g, void* dst, int n, int h,
                                  int w, int c, int d, int segrows, int pw,
                                  int ty, int slots, int aux_slots, int reuse,
                                  int tma, void* stream) {
  if (mode < 0 || mode > 2 || n < 0 || h < 0 || w < 0 || c < 1 ||
      c > 64 * kKcMax || d < 0 || d > D_MAX || ty < 1 || slots < 2 ||
      aux_slots < 2 || (reuse && slots < 2 * d + 1) ||
      !seg_ok(mode, segrows) || segrows < min(w, kM) + 2 * d ||
      (pw != 64 && !(pw == 32 && tma && c <= 32)))
    return (int)cudaErrorInvalidValue;
  if ((int64_t)n * h * w == 0) return (int)cudaGetLastError();
  const int kc = (c + pw - 1) / pw;
  const TcLayout L(mode, kc, d, segrows, pw, slots, aux_slots);
  if (L.total > kSmemMax) return (int)cudaErrorInvalidValue;
  if (tma && (c % 8 != 0 ||
              reinterpret_cast<uintptr_t>(seg) % 16 != 0 ||
              (mode == kFwd && reinterpret_cast<uintptr_t>(a) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  TcArgs args;
  args.a = static_cast<const __nv_bfloat16*>(a);
  args.seg = static_cast<const __nv_bfloat16*>(seg);
  args.g = static_cast<const float*>(g);
  args.out = mode == kFwd ? static_cast<float*>(dst) : nullptr;
  args.df = mode == kFwd ? nullptr : static_cast<__nv_bfloat16*>(dst);
  args.n = n; args.h = h; args.w = w; args.c = c; args.d = d;
  args.ty = ty; args.slots = slots; args.aux_slots = aux_slots;
  args.reuse = reuse; args.tma = tma;
  args.tiles_x = (w + kM - 1) / kM;
  args.tiles_y = (h + ty - 1) / ty;
  const long long blocks = (long long)n * args.tiles_y * args.tiles_x;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap ma = {}, ms = {};
  hopper::DeviceOf on(seg);
  if (on.error() != cudaSuccess) return (int)on.error();
  if (tma) {
    if (!feature_map(&ms, seg, n, h, w, c, segrows, pw))
      return (int)cudaErrorInvalidValue;
    if (mode == kFwd && !feature_map(&ma, a, n, h, w, c, kM, pw))
      return (int)cudaErrorInvalidValue;
  }
  return with_instance(mode, kc, segrows, pw,
                       TcLaunch{&ma, &ms, &args, (unsigned)blocks, L.total,
                                static_cast<cudaStream_t>(stream)});
}

// int[6] out: the shared-memory bytes a block of `mode` asks for at (c, d,
// segrows, pw, slots, aux_slots), the largest C, the threads a block, and
// of the current card the shared memory a block may use, the SMs and the
// blocks of that launch an SM holds
extern "C" int mcn_correlation_tc_facts(int mode, int c, int d, int segrows,
                                        int pw, int slots, int aux_slots,
                                        void* out) {
  int* o = static_cast<int*>(out);
  const int kc = (c + pw - 1) / pw;
  if (mode < 0 || mode > 2 || kc < 1 || c > 64 * kKcMax || d < 0 ||
      d > D_MAX || !seg_ok(mode, segrows) || (pw != 64 && !(pw == 32 && kc == 1)))
    return (int)cudaErrorInvalidValue;
  o[0] = TcLayout(mode, kc, d, segrows, pw, slots, aux_slots).total;
  o[1] = 64 * kKcMax;
  o[2] = kTcThreads;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&o[3], cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&o[4], cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = (cudaError_t)with_instance(mode, kc, segrows, pw,
                                   TcOccupancy{&o[5], o[0]});
  return (int)e;
}
