// Per-image bilinear shear of float32 [N, H, W, C] images, along the
// columns (axis 2) or along the rows (axis 1):
//
//   axis 2: out[n, y, x] = in[n, y, x + s[n] * y + t[n]]
//   axis 1: out[n, y, x] = in[n, y + s[n] * x + t[n], x]
//
// Replaces the Pallas TPU kernel myconvnet_tpu/ops/pallas/affine.py
// (shear_rows; shear_y and the three shears of rotate call it too).  The
// Pallas body sweeps bounded lane rolls over 32-row blocks because Mosaic
// has no vector gather.  Here the shear is a byte stream: each source byte
// comes into shared memory once, and threads write 16 bytes of output at a
// time where the rows allow it.
//
// What bounds it on the H100: bytes, one read and one write of the batch
// (0.37 ms at [1024, 224, 224, 3]) at a few operations per element.  Three
// paths, which ops/kernels/affine.py's planner picks:
//
// * rows (axis 2): the shift is constant along an output row, so the
//   source row is the output row.  A block owns a chunk of whole rows
//   (about 22 KB, contiguous in memory), which comes into shared memory
//   with one bulk copy completed on an mbarrier; the blocks an SM holds at
//   once keep the copies in flight (a grid of a few blocks an SM, each
//   walking chunks double-buffered, measured slower: PERF.md).  In a row the
//   source element of output element e is e + floor(shift) * C, and it is
//   inside the frame exactly when that index is inside the row, so no
//   element needs a division.  Rows whose bytes are not a multiple of 16
//   (or a base that is not 16-byte aligned) are staged by plain loads into
//   the same buffers and written one float at a time.
// * columns (axis 1): the shift is constant down a column.  A block owns a
//   strip of TX columns x TY output rows; it needs source rows y0 + min b
//   to y0 + TY + max b of those columns (b = floor(shift)), which for
//   |slope| (TX - 1) + 2 <= RBOX - TY rows is one TMA box [RBOX rows, TX C
//   floats] of the map [N, H, W C] (rows outside the image come back as
//   zeros; the weights are zeroed from coordinates as before).  A strip
//   whose source rows do not fit the box (a steeper slope) reads its taps
//   straight from device memory instead.  Rows that TMA cannot describe
//   (W C not a multiple of 4, a misaligned base) stage the same box by
//   plain loads.
// * direct: one block an output row, each thread reading its two taps from
//   device memory; for rows too long for shared memory (axis 2) and for
//   strips of more than 256 channels (axis 1).
//
// Arithmetic of the Pallas kernel (affine.py:59-87), each product and sum
// rounded on its own (__fmul_rn, __fadd_rn: nvcc would contract a * b + c
// into one FMA, and a changed last bit of the shift moves floor(shift) by a
// whole pixel at integer shifts), identical in every path:
//
//   shift = s * line + t;  base = floor(shift);  frac = shift - base
//   w0 = v0 ? 1 - frac : 0;  w1 = v1 ? frac : 0     (v: source in frame)
//   out = (x[base] * w0 + x[base + 1] * w1) + (1 - (w0 + w1)) * fill

#include "hopper.cuh"

namespace {

constexpr int kTileRows = 64;  // TY: output rows of a column strip
constexpr int kBoxRows = 96;   // RBOX: source rows of its TMA box
constexpr int kMaxBox = 256;   // TMA's limit on a box's elements along a dim
constexpr int kChunkBytes = 22528;  // row path: bytes of a block's chunk, about
constexpr int kRowThreads = 256;  // row path: threads a block, at most

// the shift of one line (row for axis 2, column for axis 1): the clamped
// integer part (a huge shift stays an integer outside the frame) and the
// fraction
struct Shift {
  int b0;
  float frac;
  __device__ __forceinline__ Shift(float s, float t, int line, int size) {
    const float shift = __fadd_rn(__fmul_rn(s, (float)line), t);
    const float base = floorf(shift);
    frac = __fsub_rn(shift, base);
    b0 = (int)fminf(fmaxf(base, (float)(-size - 1)), (float)size);
  }
};

// one output element from its two taps (a0, a1 read only where valid)
__device__ __forceinline__ float blend(float a0, float a1, bool v0, bool v1,
                                       float frac, float fill) {
  const float w0 = v0 ? __fsub_rn(1.f, frac) : 0.f;
  const float w1 = v1 ? frac : 0.f;
  const float gap = __fmul_rn(__fsub_rn(1.f, __fadd_rn(w0, w1)), fill);
  const float p0 = v0 ? __fmul_rn(a0, w0) : 0.f;
  const float p1 = v1 ? __fmul_rn(a1, w1) : 0.f;
  return __fadd_rn(__fadd_rn(p0, p1), gap);
}

// ---------------------------------------------------------------- direct

__global__ void shear_direct_kernel(const float* __restrict__ x,
                                    const float* __restrict__ slope,
                                    const float* __restrict__ offset,
                                    float* __restrict__ y, int h, int w,
                                    int c, int axis, float fill) {
  // one block per output row (image, row); its threads walk the row's
  // W * C elements
  const int img = blockIdx.x / h;
  const int row = blockIdx.x - img * h;
  const float s = slope[img], t = offset[img];
  const int size = axis == 2 ? w : h;
  const int wc = w * c;
  const float* src = x + (int64_t)img * h * wc;
  float* out = y + (int64_t)blockIdx.x * wc;
  for (int e = threadIdx.x; e < wc; e += blockDim.x) {
    const int col = e / c;
    const int ch = e - col * c;
    // line: the coordinate the shift depends on; pos: the sheared one
    const int line = axis == 2 ? row : col;
    const int pos = axis == 2 ? col : row;
    const Shift sh(s, t, line, size);
    const int q0 = pos + sh.b0;
    const bool v0 = q0 >= 0 && q0 < size;
    const bool v1 = q0 + 1 >= 0 && q0 + 1 < size;
    // the element of source pixel q0 along the sheared axis, and the
    // stride between the two taps
    const int64_t at0 = axis == 2 ? ((int64_t)row * w + q0) * c + ch
                                  : ((int64_t)q0 * w + col) * c + ch;
    const int tap = axis == 2 ? c : wc;
    out[e] = blend(v0 ? src[at0] : 0.f, v1 ? src[at0 + tap] : 0.f, v0, v1,
                   sh.frac, fill);
  }
}

// ------------------------------------------------------------------ rows

// grid: one block a chunk of rb whole rows (rows of the flattened [N H],
// contiguous in memory), brought into shared memory by one bulk copy
// (BULK) or by plain loads, then written as float4 (or floats)
template <bool BULK>
__global__ void __launch_bounds__(kRowThreads)
    shear_rows_kernel(const float* __restrict__ x,
                      const float* __restrict__ slope,
                      const float* __restrict__ offset, float* __restrict__ y,
                      int rows, int h, int w, int c, int rb, float fill) {
  extern __shared__ __align__(16) float buf[];  // [rb][W C]
  const int wc = w * c;
  const int r0 = blockIdx.x * rb;
  const int nr = min(rb, rows - r0);
  const uint32_t count = (uint32_t)nr * (uint32_t)wc;
  if (BULK) {
    uint64_t* bar = reinterpret_cast<uint64_t*>(buf + rb * wc);
    if (threadIdx.x == 0) {
      hopper::mbar_init(bar, 1);
      hopper::fence_barrier_init();
      hopper::mbar_expect_tx(bar, count * 4);
      hopper::bulk_load(buf, x + (int64_t)r0 * wc, count * 4, bar);
    }
    __syncthreads();  // the barrier's initialisation
    hopper::mbar_wait(bar, 0);
  } else {
    const float* src = x + (int64_t)r0 * wc;
    for (uint32_t i = threadIdx.x; i < count; i += blockDim.x) buf[i] = src[i];
    __syncthreads();
  }
  // float4 groups (or floats) of a row; thread (rr0, g0) owns group g0 (and
  // + gstep, ...) of rows rr0, + rpp, ..., so a row's shift is worked out
  // once a thread and no element needs a division
  const int groups = BULK ? wc / 4 : wc;
  const int gstep = min((int)blockDim.x, groups);
  const int rpp = blockDim.x / gstep;
  const int g0 = threadIdx.x % gstep, rr0 = threadIdx.x / gstep;
  for (int rr = rr0; rr < nr; rr += rpp) {
    const int gr = r0 + rr;  // row of the flattened [N H] (< 2^31)
    const int img = gr / h;
    const Shift sh(slope[img], offset[img], gr - img * h, w);
    // the source element of e is e + b0 * C; it is in the frame exactly
    // when that index lies in the row
    const int shift = sh.b0 * c;
    const float* line = buf + rr * wc;
    float* out = y + (int64_t)gr * wc;
    for (int gi = g0; gi < groups; gi += gstep) {
      const int e = gi * (BULK ? 4 : 1);
      float v[4];
#pragma unroll
      for (int j = 0; j < (BULK ? 4 : 1); ++j) {
        const int q0 = e + j + shift;
        const bool v0 = q0 >= 0 && q0 < wc;
        const bool v1 = q0 + c >= 0 && q0 + c < wc;
        v[j] = blend(v0 ? line[q0] : 0.f, v1 ? line[q0 + c] : 0.f, v0, v1,
                     sh.frac, fill);
      }
      if (BULK)
        *reinterpret_cast<float4*>(out + e) =
            make_float4(v[0], v[1], v[2], v[3]);
      else
        out[e] = v[0];
    }
  }
}

// --------------------------------------------------------------- columns

// grid (ceil(W / TX), ceil(H / TY), N); each thread owns V neighbouring
// elements of the strip's TX C floats and every rstep-th output row.
// TMA: V = 4, the box by one tensor load; else V = 1, staged by plain loads.
template <bool TMA>
__global__ void shear_cols_kernel(const __grid_constant__ CUtensorMap map,
                                  const float* __restrict__ x,
                                  const float* __restrict__ slope,
                                  const float* __restrict__ offset,
                                  float* __restrict__ y, int h, int w, int c,
                                  int tx, float fill) {
  constexpr int V = TMA ? 4 : 1;
  extern __shared__ __align__(128) float tile[];  // [kBoxRows][tx * c]
  const int txc = tx * c, wc = w * c;
  uint64_t& bar = *reinterpret_cast<uint64_t*>(tile + kBoxRows * txc);
  const int x0 = blockIdx.x * tx, y0 = blockIdx.y * kTileRows;
  const int img = blockIdx.z;
  const float s = slope[img], t = offset[img];
  const int xlast = min(x0 + tx, w) - 1;
  // floor(shift) is monotone in the column: its extremes are at the ends
  const int ba = Shift(s, t, x0, h).b0, bb = Shift(s, t, xlast, h).b0;
  const int bmin = min(ba, bb), bmax = max(ba, bb);
  const int row0 = y0 + bmin;  // first source row of the box
  const bool staged = kTileRows + bmax - bmin + 1 <= kBoxRows;
  const float* src = x + (int64_t)img * h * wc;
  if (staged) {
    if (TMA) {
      if (threadIdx.x == 0) {
        hopper::mbar_init(&bar, 1);
        hopper::fence_barrier_init();
        hopper::mbar_expect_tx(&bar, kBoxRows * txc * 4);
        hopper::tma_load_3d(tile, &map, &bar, x0 * c, row0, img);
      }
    } else {
      for (int i = threadIdx.x; i < kBoxRows * txc; i += blockDim.x) {
        const int rr = i / txc, e = i - rr * txc;
        const int q = row0 + rr;
        tile[i] = q >= 0 && q < h && x0 * c + e < wc
                      ? src[(int64_t)q * wc + x0 * c + e]
                      : 0.f;
      }
    }
  }
  // this thread's elements: their columns' shifts, once
  const int groups = txc / V;
  const int g = threadIdx.x % groups;
  const int rstep = blockDim.x / groups;
  int b[V];
  float frac[V];
  bool inside = true;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int col = x0 + (g * V + j) / c;
    const Shift sh(s, t, col, h);
    b[j] = sh.b0;
    frac[j] = sh.frac;
    inside = inside && col < w;
  }
  if (staged) {
    if (TMA) {
      __syncthreads();  // the barrier's initialisation
      hopper::mbar_wait(&bar, 0);
    } else {
      __syncthreads();
    }
  }
  if (!inside || threadIdx.x >= groups * rstep) return;
  const int ylast = min(y0 + kTileRows, h);
  for (int yy = y0 + threadIdx.x / groups; yy < ylast; yy += rstep) {
    float v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int e = g * V + j;
      const int q0 = yy + b[j];
      const bool v0 = q0 >= 0 && q0 < h;
      const bool v1 = q0 + 1 >= 0 && q0 + 1 < h;
      float a0 = 0.f, a1 = 0.f;
      if (staged) {
        const float* p = tile + (q0 - row0) * txc + e;
        if (v0) a0 = p[0];
        if (v1) a1 = p[txc];
      } else {
        const float* p = src + (int64_t)q0 * wc + x0 * c + e;
        if (v0) a0 = p[0];
        if (v1) a1 = p[wc];
      }
      v[j] = blend(a0, a1, v0, v1, frac[j], fill);
    }
    float* o = y + ((int64_t)img * h + yy) * wc + x0 * c + g * V;
    if (TMA)
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    else
      *o = v[0];
  }
}

template <typename K>
cudaError_t opt_in(K kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              227 * 1024);
}

cudaError_t opt_in_all() {
  static const cudaError_t err = [] {
    cudaError_t e = opt_in(shear_rows_kernel<true>);
    if (e == cudaSuccess) e = opt_in(shear_rows_kernel<false>);
    if (e == cudaSuccess) e = opt_in(shear_cols_kernel<true>);
    if (e == cudaSuccess) e = opt_in(shear_cols_kernel<false>);
    return e;
  }();
  return err;
}

}  // namespace

// x, slope [N], offset [N], y, n, h, w, c, axis (2: columns, 1: rows),
// fill, path (0 direct, 1 staged by plain loads, 2 bulk copy or TMA), p0,
// p1 (axis 2: rows a block, unused; axis 1: TX, threads), stream
extern "C" int mcn_shear_f32(const void* x, const void* slope,
                             const void* offset, void* y, int n, int h, int w,
                             int c, int axis, float fill, int path, int p0,
                             int p1, void* stream) {
  if ((int64_t)n * h * w == 0 || c == 0) return (int)cudaGetLastError();
  if ((axis != 1 && axis != 2) || c < 0 || (int64_t)n * h > 0x7fffffff ||
      (int64_t)w * c > (1 << 30) || path < 0 || path > 2)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* sf = static_cast<const float*>(slope);
  const float* of = static_cast<const float*>(offset);
  float* yf = static_cast<float*>(y);
  const int wc = w * c;
  if (path == 0) {
    // up to 256 threads, a warp multiple, spread evenly over the passes a
    // row takes
    const int passes = (wc + 255) / 256;
    const int threads = ((wc + passes - 1) / passes + 31) / 32 * 32;
    shear_direct_kernel<<<(unsigned)(n * h), threads, 0, st>>>(
        xf, sf, of, yf, h, w, c, axis, fill);
    return (int)cudaGetLastError();
  }
  const cudaError_t opted = opt_in_all();
  if (opted != cudaSuccess) return (int)opted;
  const bool fast = path == 2;
  if (axis == 2) {
    const int rb = p0;
    const size_t smem = (size_t)rb * wc * 4 + 16;
    if (rb < 1 || smem > 227 * 1024 ||
        (fast && ((wc % 4) != 0 ||
                  reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
                  reinterpret_cast<uintptr_t>(y) % 16 != 0)))
      return (int)cudaErrorInvalidValue;
    auto kernel = fast ? shear_rows_kernel<true> : shear_rows_kernel<false>;
    // a whole number of rows of groups (168 threads for 224 x 3)
    const int groups = fast ? wc / 4 : wc;
    const int threads =
        groups <= kRowThreads ? groups * (kRowThreads / groups) : kRowThreads;
    const int blocks = (n * h + rb - 1) / rb;
    kernel<<<blocks, threads, smem, st>>>(xf, sf, of, yf, n * h, h, w, c, rb,
                                          fill);
    return (int)cudaGetLastError();
  }
  const int tx = p0, threads = p1;
  const int txc = tx * c;
  const size_t smem = (size_t)kBoxRows * txc * 4 + 16;
  const int groups = fast ? txc / 4 : txc;
  if (tx < 1 || txc > kMaxBox || smem > 227 * 1024 || threads < groups ||
      threads > 1024 || threads % groups != 0 ||
      (fast && (txc % 4 != 0 || wc % 4 != 0 ||
                reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
                reinterpret_cast<uintptr_t>(y) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map = {};
  hopper::DeviceOf on(x);
  if (on.error() != cudaSuccess) return (int)on.error();
  if (fast) {
    const uint64_t dims[3] = {(uint64_t)wc, (uint64_t)h, (uint64_t)n};
    const uint64_t strides[2] = {(uint64_t)wc * 4, (uint64_t)h * wc * 4};
    const uint32_t box[3] = {(uint32_t)txc, (uint32_t)kBoxRows, 1};
    if (!hopper::encode_tiled(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                              CU_TENSOR_MAP_SWIZZLE_NONE, x, 3, dims, strides,
                              box))
      return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((w + tx - 1) / tx, (h + kTileRows - 1) / kTileRows, n);
  auto kernel = fast ? shear_cols_kernel<true> : shear_cols_kernel<false>;
  kernel<<<grid, threads, smem, st>>>(map, xf, sf, of, yf, h, w, c, tx, fill);
  return (int)cudaGetLastError();
}

// int[5] out: output rows of a column strip, source rows of its box, the
// largest box extent, the row path's chunk bytes and threads
extern "C" int mcn_shear_facts(void* out) {
  int* o = static_cast<int*>(out);
  o[0] = kTileRows;
  o[1] = kBoxRows;
  o[2] = kMaxBox;
  o[3] = kChunkBytes;
  o[4] = kRowThreads;
  return 0;
}
