// Per-image bilinear shear of float32 [N, H, W, C] images, along the
// columns (axis 2) or along the rows (axis 1):
//
//   axis 2: out[n, y, x] = in[n, y, x + s[n] * y + t[n]]
//   axis 1: out[n, y, x] = in[n, y + s[n] * x + t[n], x]
//
// Replaces the Pallas TPU kernel myconvnet_tpu/ops/pallas/affine.py
// (shear_rows; shear_y and the three shears of rotate call it too).  The
// Pallas body sweeps bounded lane rolls over 32-row blocks because Mosaic
// has no vector gather; here a block owns one output row and each of its
// threads one output element at a time, reading its two source elements
// along the sheared axis directly, so any slope works and a column shear
// needs no transpose.  The block's image and row come from one division a
// block, not a 64-bit one a pixel.
//
// What bounds it on the H100: bytes.  Each element is read about once and
// written once (the two taps of neighbouring threads overlap in L1/L2), at
// a few operations per element.  Neighbouring threads own neighbouring
// elements, so stores are coalesced, and so are the loads of a row shear
// (a whole row moves by one shift); those of a column shear nearly so,
// since the source row moves slowly along x.
//
// Arithmetic of the Pallas kernel (affine.py:59-87), each product and sum
// rounded on its own (__fmul_rn, __fadd_rn: nvcc would contract a * b + c
// into one FMA, and a changed last bit of the shift moves floor(shift) by a
// whole pixel at integer shifts):
//
//   shift = s * line + t;  base = floor(shift);  frac = shift - base
//   w0 = v0 ? 1 - frac : 0;  w1 = v1 ? frac : 0     (v: source in frame)
//   out = (x[base] * w0 + x[base + 1] * w1) + (1 - (w0 + w1)) * fill

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void shear_kernel(const float* __restrict__ x,
                             const float* __restrict__ slope,
                             const float* __restrict__ offset,
                             float* __restrict__ y, int h, int w, int c,
                             int axis, float fill) {
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
    const float shift = __fadd_rn(__fmul_rn(s, (float)line), t);
    const float base = floorf(shift);
    const float frac = __fsub_rn(shift, base);
    // clamped so that a huge shift stays an integer outside the frame
    const int b0 = (int)fminf(fmaxf(base, (float)(-size - 1)), (float)size);
    const int q0 = pos + b0;
    const bool v0 = q0 >= 0 && q0 < size;
    const bool v1 = q0 + 1 >= 0 && q0 + 1 < size;
    const float w0 = v0 ? __fsub_rn(1.f, frac) : 0.f;
    const float w1 = v1 ? frac : 0.f;
    const float gap = __fmul_rn(__fsub_rn(1.f, __fadd_rn(w0, w1)), fill);
    // the element of source pixel q0 along the sheared axis, and the
    // stride between the two taps
    const int64_t at0 = axis == 2 ? ((int64_t)row * w + q0) * c + ch
                                  : ((int64_t)q0 * w + col) * c + ch;
    const int tap = axis == 2 ? c : wc;
    const float p0 = v0 ? __fmul_rn(src[at0], w0) : 0.f;
    const float p1 = v1 ? __fmul_rn(src[at0 + tap], w1) : 0.f;
    out[e] = __fadd_rn(__fadd_rn(p0, p1), gap);
  }
}

}  // namespace

// x, slope [N], offset [N], y, n, h, w, c, axis (2: columns, 1: rows),
// fill, stream
extern "C" int mcn_shear_f32(const void* x, const void* slope,
                             const void* offset, void* y, int n, int h, int w,
                             int c, int axis, float fill, void* stream) {
  if ((int64_t)n * h * w == 0 || c == 0) return (int)cudaGetLastError();
  if ((axis != 1 && axis != 2) || c < 0 || (int64_t)n * h > 0x7fffffff ||
      (int64_t)w * c > (1 << 30))
    return (int)cudaErrorInvalidValue;
  // up to 256 threads, a warp multiple, spread evenly over the passes a
  // row takes (224 threads, three passes, for 224 x 3)
  const int wc = w * c, passes = (wc + 255) / 256;
  const int threads = ((wc + passes - 1) / passes + 31) / 32 * 32;
  shear_kernel<<<(unsigned)(n * h), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(slope),
      static_cast<const float*>(offset), static_cast<float*>(y), h, w, c,
      axis, fill);
  return (int)cudaGetLastError();
}
