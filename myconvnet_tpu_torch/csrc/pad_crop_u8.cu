// CIFAR-style training input in one pass: per-image integer pad-and-crop
// (zero fill outside the frame), optional horizontal flip, normalize.
//
// Replaces the Pallas TPU kernel myconvnet_tpu/ops/pallas/pad_crop_u8.py
// (pad_crop_flip_normalize).  x is [N, H, W, C] uint8; offsets is [N, 2]
// int32 (row shift sy, column shift sx, any values); flip is [N] bool bytes
// (non-zero flips); mean and std are [C] float32, folded into scale =
// 1 / (255 * std) and shift = -mean / std as in normalize_u8.cu; y is
// [N, H, W, C] float32 or bf16.
//
//   y[n, r, q, c] = v * scale[c] + shift[c],
//   v = x[n, r + sy, q' + sx, c] inside the frame, else 0,
//   q' = W - 1 - q when the image is flipped, else q.
//
// Crop first, then flip, as the Pallas kernel does (it rolls and masks,
// then flips the cropped block with a permutation matmul).  Offsets and
// flips are read on the device: no host sync.
//
// What bounds it on the H100: bytes (one read of x, one write of y, 5 or 3
// bytes an element).  At the recipe's [128, 32, 32, 3] that is 0.6 us, far
// under a launch's fixed cost, so the design is cut for a short critical
// path there and for streaming at large shapes:
//
// * a work item is a band of output rows of one image; the Python planner
//   (ops/kernels/pad_crop_u8.py: plan) sizes the bands and the grid, one
//   wave of blocks that walk the items.  Output row r reads source row
//   r + sy only, so an item's source rows are one contiguous span of x,
//   staged in shared memory by 16-byte cp.async copies, the ragged bytes
//   at its ends by plain loads.  A band with no row in the frame copies
//   nothing.  A block that walks several items copies the next one into a
//   second buffer while it writes the current one (that item's offsets
//   were loaded an item earlier, so the copy waits on no load).  When a
//   band is a whole image (the recipe's 3 KB images, a block an image)
//   the whole image is staged before the offsets arrive, so their load is
//   off the critical path;
// * a block reads its image's offsets and flip once an item; the fold of
//   mean and std into a [C] table in shared memory runs while the first
//   copy is in flight, and one barrier covers both;
// * the item's output is one contiguous span, written with 16-byte stores
//   (4 f32 or 8 bf16) over the span, not row by row (a 28-wide bf16 row is
//   56 bytes), neighbouring threads on neighbouring vectors.  Vector k of
//   the span and k + period, period = W C / gcd(W C, VEC), start at the
//   same column and channel, VEC / gcd rows apart, so each thread keeps a
//   fixed position: its lanes' shared-memory offsets (shift and flip
//   applied), rows, scales and shifts are worked out once an item, and a
//   vector costs per element one add, one compare, one shared-memory
//   byte, a multiply and an add.  The set-up divides by multiply and
//   shift (FastDiv).  Elements outside the frame write shift[c] without a
//   read.  32-bit indices inside an item.
//
// Rows too wide for shared memory (DIRECT) read x directly.  Multiply and
// add round separately, as in the plain version: bit-exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::FastDiv;

constexpr int kMaxThreads = 512;
constexpr int kMinBlocks = 2;     // blocks of kMaxThreads an SM (<= 64 regs)
constexpr int kMaxC = 4096;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kInvalidRow = -(1 << 30);  // a lane whose column is outside

struct Args {
  const uint8_t* x;
  const int* offsets;
  const uint8_t* flip;
  const float* mean;
  const float* stdev;
  void* y;
  int h, w;
  FastDiv c, wc;      // C, W C
  int rows;           // rows a band (H: a band is the whole image)
  FastDiv bands;      // bands an image
  int items;          // N bands
  FastDiv period;     // 16-byte output vectors before the column repeats
  int rpp;            // rows those vectors span
  int table_bytes;    // the [C] (scale, shift) table, 16-byte multiple
  int stage_bytes;    // a buffer of a band's rows, 16-byte multiple
};

// An image's offsets and flip as loaded, an item ahead of their use
struct Offsets {
  int sy, sx;
  uint32_t flip;
};

__device__ __forceinline__ Offsets load_offsets(const Args& a, int item) {
  const int n = a.bands.div(item);
  return {__ldg(a.offsets + 2 * n), __ldg(a.offsets + 2 * n + 1),
          __ldg(a.flip + n)};
}

// A band in flight: image n's output rows [r0, r0 + nr), its source rows
// [lo, hi) staged from src (row lo first), its offsets, and the byte of
// the span's ragged ends this thread loaded (written to edge_dst before
// the band's barrier)
struct Item {
  int n, r0, nr, lo, hi, sy, sx;
  bool flipped;
  const uint8_t* src;
  uint8_t* edge_dst;
  uint32_t edge;
};

__device__ __forceinline__ float2 fold(const float* __restrict__ mean,
                                       const float* __restrict__ stdev,
                                       int c) {
  const float s = __ldg(stdev + c);
  return make_float2(__fdiv_rn(1.f, __fmul_rn(255.f, s)),
                     __fdiv_rn(-__ldg(mean + c), s));
}

__device__ __forceinline__ float norm(uint32_t v, float2 f) {
  return __fadd_rn(__fmul_rn((float)v, f.x), f.y);
}

__device__ __forceinline__ void store1(float* y, float v) { *y = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* y, float v) {
  *y = __float2bfloat16_rn(v);
}

// a 16-byte store of the output
__device__ __forceinline__ void put(float4* p, float4 v) { *p = v; }
__device__ __forceinline__ void put(uint4* p, uint4 v) { *p = v; }

__device__ __forceinline__ void store16(float* y, const float* v) {
  put(reinterpret_cast<float4*>(y), make_float4(v[0], v[1], v[2], v[3]));
}

__device__ __forceinline__ void store16(__nv_bfloat16* y, const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  put(reinterpret_cast<uint4*>(y), make_uint4(w[0], w[1], w[2], w[3]));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Starts the copy of src[0, len) into buf + (src mod 16), so that both
// sides of its 16-byte body are aligned, and returns where src[0] lands.
// The body goes by cp.async; this thread's byte of the < 16 at each end is
// loaded into it->edge.
__device__ __forceinline__ uint8_t* stage_span(const uint8_t* src, int len,
                                               uint8_t* buf, Item* it) {
  const int t = threadIdx.x;
  const int phi = (int)(reinterpret_cast<uintptr_t>(src) & 15);
  uint8_t* o = buf + phi;
  const int head = min(len, (16 - phi) & 15);
  const int body = (len - head) & ~15;
  const int tail = len - head - body;
  for (int m = 16 * t; m < body; m += 16 * blockDim.x)
    hopper::cp_async_16(o + head + m, src + head + m);
  const int e = t < head ? t : body + t;
  if (t < head + tail) {
    it->edge = src[e];
    it->edge_dst = o + e;
  }
  return o;
}

// Item `item` with its offsets `o` (loaded earlier), and (unless DIRECT)
// its copy into buf started as one cp.async group (empty when nothing is
// copied).  A whole image is copied before o is looked at.
template <bool DIRECT>
__device__ __forceinline__ Item start_item(const Args& a, int item,
                                           uint8_t* buf, const Offsets& o) {
  Item it;
  it.n = a.bands.div(item);
  it.r0 = (item - it.n * a.bands.d) * a.rows;
  it.nr = min(a.rows, a.h - it.r0);
  it.lo = 0, it.hi = a.h, it.edge_dst = nullptr, it.edge = 0;
  const int wc = a.wc.d;
  const uint8_t* img = a.x + (int64_t)it.n * a.h * wc;
  it.src = DIRECT ? img : buf;
  const bool whole = a.rows == a.h;
  if (!DIRECT && whole) it.src = stage_span(img, a.h * wc, buf, &it);
  it.sy = clampi(o.sy, -a.h, a.h);
  it.sx = clampi(o.sx, -a.w, a.w);
  it.flipped = o.flip != 0;
  if (!DIRECT && !whole) {
    it.lo = clampi(it.r0 + it.sy, 0, a.h);
    it.hi = max(it.lo, clampi(it.r0 + it.nr + it.sy, 0, a.h));
    if (it.hi > it.lo)
      it.src = stage_span(img + it.lo * wc, (it.hi - it.lo) * wc, buf, &it);
  }
  hopper::cp_async_commit();
  return it;
}

template <typename T, bool DIRECT>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    pad_crop_kernel(const Args a) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) uint8_t smem[];
  float2* table = reinterpret_cast<float2*>(smem);
  uint8_t* stage = smem + a.table_bytes;
  const int t = threadIdx.x, nt = blockDim.x;
  const int wc = a.wc.d, c = a.c.d, period = a.period.d;
  // this thread's positions: p0, p0 + pstep, ... < period, and for each the
  // vectors (q0 + i qstep) period + p of an item
  int p0, pstep, q0, qstep;
  if (nt >= period) {
    qstep = a.period.div(nt);
    q0 = a.period.div(t);
    p0 = q0 < qstep ? t - q0 * period : period;  // else idle
    pstep = period;
  } else {
    qstep = 1, q0 = 0, p0 = t, pstep = nt;
  }
  const int grid = gridDim.x;
  Item cur = start_item<DIRECT>(a, blockIdx.x, stage,
                                load_offsets(a, blockIdx.x));
  // the offsets of the next item, loaded an item ahead of its copy
  Offsets ahead{};
  if (blockIdx.x + grid < a.items) ahead = load_offsets(a, blockIdx.x + grid);
  for (int i = t; i < c; i += nt) table[i] = fold(a.mean, a.stdev, i);
  for (int item = blockIdx.x, iter = 0; item < a.items;
       item += grid, ++iter) {
    // the next item's copy flies while this one is written
    const bool more = item + grid < a.items;
    Item next;
    if (more) {
      next = start_item<DIRECT>(a, item + grid,
                                stage + ((iter + 1) & 1) * a.stage_bytes,
                                ahead);
      if (item + 2 * grid < a.items) ahead = load_offsets(a, item + 2 * grid);
    } else {
      hopper::cp_async_commit();
    }
    hopper::cp_async_wait_group<1>();
    if (cur.edge_dst) *cur.edge_dst = (uint8_t)cur.edge;
    __syncthreads();

    // band row b reads row b + rel0 of src, inside the frame when that
    // lies in [0, nrows); a pixel of column base u (= q C) reads column
    // base colbase + dir u of that row, inside when in [0, W C)
    const uint8_t* src = cur.src;
    const int nrows = cur.hi - cur.lo;
    const int rel0 = cur.r0 + cur.sy - cur.lo;
    const int colbase = cur.flipped ? (a.w - 1 + cur.sx) * c : cur.sx * c;
    const int dir = cur.flipped ? -1 : 1;
    const int64_t e0 = ((int64_t)cur.n * a.h + cur.r0) * wc;
    const int len = cur.nr * wc;
    const int a0 = min(len, (int)((VEC - e0 % VEC) % VEC));  // to alignment
    const int nv = (len - a0) / VEC;
    T* yb = static_cast<T*>(a.y) + e0;
    for (int p = p0; p < period; p += pstep) {
      int rrow[VEC], base[VEC];
      float2 f[VEC];
      const int o = a0 + p * VEC;
      int rb = a.wc.div(o), j = o - rb * wc, ch = a.c.mod(j);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int sb = colbase + dir * (j - ch);
        const int rr = rb + rel0;
        rrow[i] = (unsigned)sb < (unsigned)wc ? rr : kInvalidRow;
        base[i] = rr * wc + sb + ch;
        f[i] = table[ch];
        if (++ch == c) ch = 0;
        if (++j == wc) j = 0, ch = 0, ++rb;
      }
      for (int q = q0, k = q0 * period + p; k < nv;
           q += qstep, k += qstep * period) {
        const int qr = q * a.rpp, qo = qr * wc;
        float v[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const uint32_t px =
              (unsigned)(rrow[i] + qr) < (unsigned)nrows ? src[base[i] + qo]
                                                         : 0u;
          v[i] = norm(px, f[i]);
        }
        store16(yb + a0 + k * VEC, v);
      }
    }
    // the < VEC elements before the first aligned vector and after the last
    const int tail0 = a0 + nv * VEC;
    if (t < a0 + len - tail0) {
      const int e = t < a0 ? t : tail0 + t - a0;
      const int rb = a.wc.div(e), j = e - rb * wc, ch = a.c.mod(j);
      const int sb = colbase + dir * (j - ch);
      const int rr = rb + rel0;
      const uint32_t px =
          (unsigned)sb < (unsigned)wc && (unsigned)rr < (unsigned)nrows
              ? src[rr * wc + sb + ch]
              : 0u;
      store1(yb + e, norm(px, table[ch]));
    }
    if (more) {
      __syncthreads();  // every read of this item's buffer is done
      cur = next;
    }
  }
}

template <typename T, bool DIRECT>
cudaError_t opt_in() {
  static const cudaError_t err = cudaFuncSetAttribute(
      pad_crop_kernel<T, DIRECT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return err;
}

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// The launch facts the planner derives too; returns the shared memory a
// block needs with `buffers` stage buffers, or -1 for what the kernel does
// not take.
template <typename T>
int fill_args(Args* a, int n, int h, int w, int c, int rows, bool direct,
              int buffers) {
  constexpr int VEC = 16 / sizeof(T);
  if (n < 0 || h <= 0 || w <= 0 || c <= 0 || c > kMaxC || rows < 1 ||
      rows > h)
    return -1;
  const int64_t wc = (int64_t)w * c;
  // 32-bit indices: offsets inside an image (and its rows shifted by up
  // to H) and an item's elements
  if (3 * (int64_t)h * wc >= (1ll << 30)) return -1;
  const int bands = (h + rows - 1) / rows;
  if ((int64_t)n * bands > 0x7fffffffLL) return -1;
  a->h = h, a->w = w, a->rows = rows, a->items = n * bands;
  a->c = FastDiv(c), a->wc = FastDiv((int)wc), a->bands = FastDiv(bands);
  const int g = gcd((int)wc, VEC);
  a->period = FastDiv((int)wc / g);
  a->rpp = VEC / g;
  a->table_bytes = (8 * c + 15) & ~15;
  const int64_t stage = direct ? 0 : (rows * wc + 16 + 15) & ~15ll;
  if (stage > kMaxSmem) return -1;
  a->stage_bytes = (int)stage;
  const int64_t smem = a->table_bytes + buffers * stage;
  return smem > kMaxSmem ? -1 : (int)smem;
}

template <typename T>
int launch(const void* x, const void* offsets, const void* flip,
           const void* mean, const void* stdev, void* y, int n, int h, int w,
           int c, int rows, int direct, int threads, int blocks, int smem,
           void* stream) {
  Args a;
  if (blocks < 1 || rows < 1 || (direct != 0 && direct != 1))
    return (int)cudaErrorInvalidValue;
  // two buffers when a block walks more than one band
  const bool walks = (int64_t)n * ((h + rows - 1) / rows) > blocks;
  const int need = fill_args<T>(&a, n, h, w, c, rows, direct, walks ? 2 : 1);
  if (need < 0 || smem < need || smem > kMaxSmem || threads < 32 ||
      threads > kMaxThreads || (uintptr_t)y % 16)
    return (int)cudaErrorInvalidValue;
  if (a.items == 0) return (int)cudaGetLastError();
  a.x = static_cast<const uint8_t*>(x);
  a.offsets = static_cast<const int*>(offsets);
  a.flip = static_cast<const uint8_t*>(flip);
  a.mean = static_cast<const float*>(mean);
  a.stdev = static_cast<const float*>(stdev);
  a.y = y;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (direct) {
    if ((e = opt_in<T, true>()) == cudaSuccess)
      pad_crop_kernel<T, true><<<blocks, threads, smem, s>>>(a);
  } else {
    if ((e = opt_in<T, false>()) == cudaSuccess)
      pad_crop_kernel<T, false><<<blocks, threads, smem, s>>>(a);
  }
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T>
cudaError_t occupancy(int* out, bool direct, int threads, int smem) {
  cudaError_t e;
  if (direct) {
    if ((e = opt_in<T, true>()) != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, pad_crop_kernel<T, true>, threads, smem);
  }
  if ((e = opt_in<T, false>()) != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, pad_crop_kernel<T, false>, threads, smem);
}

}  // namespace

// x, offsets [N, 2] int32, flip [N] bool, mean, std, y, n, h, w, c, rows a
// band, direct (1: no staging), threads, blocks, shared-memory bytes
// (ops/kernels/pad_crop_u8.py's planner), stream
extern "C" int mcn_pad_crop_u8_f32(const void* x, const void* offsets,
                                   const void* flip, const void* mean,
                                   const void* stdev, void* y, int n, int h,
                                   int w, int c, int rows, int direct,
                                   int threads, int blocks, int smem,
                                   void* stream) {
  return launch<float>(x, offsets, flip, mean, stdev, y, n, h, w, c, rows,
                       direct, threads, blocks, smem, stream);
}

extern "C" int mcn_pad_crop_u8_bf16(const void* x, const void* offsets,
                                    const void* flip, const void* mean,
                                    const void* stdev, void* y, int n, int h,
                                    int w, int c, int rows, int direct,
                                    int threads, int blocks, int smem,
                                    void* stream) {
  return launch<__nv_bfloat16>(x, offsets, flip, mean, stdev, y, n, h, w, c,
                               rows, direct, threads, blocks, smem, stream);
}

// What the Python planner assumes, for the card tests to hold against it.
// direct, threads, shared-memory bytes a block; out[0..3]: SMs of the
// current device, blocks an SM holds of the f32 and the bf16 kernel at
// that launch, kMaxThreads.
extern "C" int mcn_pad_crop_u8_facts(int direct, int threads, int smem,
                                     int* out) {
  if (direct != 0 && direct != 1) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = occupancy<float>(&out[1], direct, threads, smem);
  if (e == cudaSuccess)
    e = occupancy<__nv_bfloat16>(&out[2], direct, threads, smem);
  out[3] = kMaxThreads;
  return (int)e;
}
