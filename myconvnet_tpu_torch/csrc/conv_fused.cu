// 3x3 stride-1 SAME convolution with a BN-apply + ReLU epilogue, as an
// implicit GEMM:
//   y[p, o] = relu(scale[o] * sum_{tap, c} x[p + tap, c] * w[o, tap, c]
//                  + bias[o])
//
// Replaces the Pallas TPU kernel myconvnet_tpu/ops/pallas/conv_fused.py
// (conv3x3_bn_relu).  Layouts: x [N, H, W, C] bf16; w [Cout, 3, 3, C] bf16
// (an OIHW weight stored channels_last); scale, bias [Cout] float32;
// y [N, H, W, Cout] bf16.  Accumulation is float32 and the epilogue runs on
// the float32 sum before the one bf16 store, as in the Pallas kernel.
//
// The GEMM: M = N*H*W output pixels, N = Cout, K = 9*C.  The Pallas kernel
// builds the whole [pixels, 9*C] im2col matrix in VMEM and runs one matmul;
// a block here has 227 KB of shared memory at most, so it streams K instead:
// one stage is one tap (dy, dx) x 32 input channels.  The A rows of a stage
// are the input pixels p + (dy, dx), zero-filled by cp.async where they
// fall outside the image (SAME padding) or past C; the B rows are the
// weights of the block's output channels at that tap.  Two stage buffers:
// the next stage loads while the tensor cores work on this one.
//
// What bounds it on the H100: at ResNet-18's CIFAR shapes (8x8x64 down to
// 1x1x512 at batch 128) each conv is 0.04-0.6 GFLOP over 0.5-5 MB, and the
// grid is 16-128 blocks, so neither roofline is reached; the limit is how
// few blocks there are and how much each waits on its loads.  Taps that
// read only padding for every pixel (dy != 0 when H == 1, dx != 0 when
// W == 1) are skipped, so the 1x1 map reads the centre tap alone.
//
// Design, kept simple before it is made fast: 4 warps per block, a block
// tile of 64 pixels x 64 output channels, each warp 32 x 32 as 2 x 2 bf16
// WMMA tiles (16x16x16, float32 accumulators).  Later work: wgmma fed by
// TMA, more blocks at the small maps (split K over a cluster).

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBM = 64;          // output pixels per block
constexpr int kBN = 64;          // output channels per block
constexpr int kKC = 32;          // input channels per stage
constexpr int kLd = kKC + 8;     // staged row stride (bf16), 80 B
constexpr int kVecs = kKC / 8;   // 16-byte vectors per staged row
constexpr int kStage = (kBM + kBN) * kLd;

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* wt;
  const float* scale;
  const float* bias;
  __nv_bfloat16* y;
  int n, h, w, c, cout;
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__global__ void __launch_bounds__(kThreads)
    conv3x3_bn_relu_kernel(const Args p) {
  __shared__ __align__(128) __nv_bfloat16 stage[2 * kStage];
  __shared__ __align__(32) float scratch[kWarps * 256];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;  // the warp's 32 x 32 sub-tile
  const int hw = p.h * p.w;
  const int npix = p.n * hw;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int kchunks = (p.c + kKC - 1) / kKC;
  // taps that read inside the image for some pixel
  const int ry = p.h > 1 ? 1 : 0, rx = p.w > 1 ? 1 : 0;
  const int tx = 2 * rx + 1;
  const int steps = (2 * ry + 1) * tx * kchunks;

  auto load = [&](int s, int buf) {
    const int tap = s / kchunks;
    const int dy = tap / tx - ry, dx = tap % tx - rx;
    const int k0 = (s % kchunks) * kKC;
    __nv_bfloat16* dst = stage + buf * kStage;
    for (int i = threadIdx.x; i < (kBM + kBN) * kVecs; i += kThreads) {
      const int r = i / kVecs, ch = k0 + (i % kVecs) * 8;
      const __nv_bfloat16* src = p.wt;  // any valid address for a fill
      int fill = 16;
      if (ch < p.c) {
        if (r < kBM) {
          const int pix = m0 + r;
          if (pix < npix) {
            const int img = pix / hw, rem = pix % hw;
            const int yy = rem / p.w + dy, xx = rem % p.w + dx;
            if (yy >= 0 && yy < p.h && xx >= 0 && xx < p.w) {
              src = p.x + ((size_t)img * hw + (size_t)yy * p.w + xx) * p.c + ch;
              fill = 0;
            }
          }
        } else {
          const int o = n0 + r - kBM;
          if (o < p.cout) {
            src = p.wt + ((size_t)o * 9 + (dy + 1) * 3 + (dx + 1)) * p.c + ch;
            fill = 0;
          }
        }
      }
      __pipeline_memcpy_async(dst + r * kLd + (i % kVecs) * 8, src, 16, fill);
    }
    __pipeline_commit();
  };

  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load(0, 0);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      load(s + 1, (s + 1) & 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // stage s is in shared memory
    const __nv_bfloat16* a = stage + (s & 1) * kStage;
    const __nv_bfloat16* b = a + kBM * kLd;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      FragA fa[2];
      FragB fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm * 32 + i * 16) * kLd + kk, kLd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], b + (wn * 32 + j * 16) * kLd + kk, kLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // done with buffer s & 1 before it is refilled
  }

  float* ws = scratch + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(ws, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int pix = m0 + wm * 32 + i * 16 + e / 16;
        const int o = n0 + wn * 32 + j * 16 + e % 16;
        if (pix < npix && o < p.cout) {
          float v = __fadd_rn(__fmul_rn(ws[e], p.scale[o]), p.bias[o]);
          v = v < 0.f ? 0.f : v;
          p.y[(size_t)pix * p.cout + o] = __float2bfloat16_rn(v);
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int mcn_conv3x3_bn_relu(const void* x, const void* wt,
                                   const void* scale, const void* bias,
                                   void* y, int n, int h, int w, int c,
                                   int cout, void* stream) {
  if (n < 0 || h <= 0 || w <= 0 || c <= 0 || c % 8 != 0 || cout <= 0)
    return (int)cudaErrorInvalidValue;
  const long long npix = (long long)n * h * w;
  if (npix == 0) return (int)cudaGetLastError();
  if (npix > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.wt = static_cast<const __nv_bfloat16*>(wt);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.n = n; a.h = h; a.w = w; a.c = c; a.cout = cout;
  const dim3 grid((unsigned)((npix + kBM - 1) / kBM),
                  (unsigned)((cout + kBN - 1) / kBN), 1);
  conv3x3_bn_relu_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
