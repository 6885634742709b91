// 3x3 stride-1 SAME convolution with a BN-apply + ReLU epilogue, as an
// implicit GEMM:
//   y[p, o] = relu(scale[o] * sum_{tap, c} x[p + tap, c] * w[o, tap, c]
//                  + bias[o])
//
// Replaces the Pallas TPU kernel myconvnet_tpu/ops/pallas/conv_fused.py
// (conv3x3_bn_relu).  Layouts: x [N, H, W, C] bf16; w [Cout, 3, 3, C] bf16
// (an OIHW weight stored channels_last); scale, bias [Cout] float32;
// y [N, H, W, Cout] bf16.  Accumulation is float32 and the epilogue runs on
// the float32 sum before the one bf16 store, as in the Pallas kernel, with
// the product and the sum rounded apart as the plain version rounds them.
//
// The GEMM: M = N*H*W output pixels, N = Cout, K = taps x C.  The Pallas
// kernel builds the whole [pixels, 9*C] im2col matrix in VMEM and runs one
// matmul; here K streams through shared memory, one stage being one tap x
// 64 input channels.
//
// What bounds it on the H100: at CIFAR-100 ResNet-18's five eval sites
// (batch 128; 8x8x64 twice, 4x4x128, 2x2x256, 1x1x512, Cout = C) each conv
// moves 0.3-2.4 MB and does 0.07-0.6 GFLOP: 3.7 us of HBM time for the
// five, under 3 us of tensor-core time.  Neither is close; what costs is
// latency: how many blocks the card gets and how long each one walks K.
// With 64x64 output tiles M is small at the small maps (2,048, 512 and 128
// pixels) while K is long (1,152 to 2,304), so a grid of output tiles
// alone has 64, 32 and 16 blocks on 132 SMs, each streaming 18-36 stages.
//
// Design, from Hopper's parts (csrc/hopper.cuh):
// * a block is one consumer warpgroup and one producer warp and owns a
//   64-pixel x 64-channel output tile: the pixels are a box of G images x
//   TH x TW, G*TH*TW <= 64 (whole images where H*W divides 64, else a
//   window of one image; rows of the tile past the box are computed and
//   never stored);
// * the producer's lane 0 keeps a ring of kStages stages full by TMA: the
//   A tile through a 4-D tensor map over NHWC x, at (c0, x0 + dx - 1,
//   y0 + dy - 1, n0), whose zero fill outside the tensor is the SAME
//   padding (and the channel tail past C); the B tile through a 3-D map
//   over the weight, 64 output channels x 64 input channels of one tap,
//   encoded once per weight and cached.  Both land 128-byte swizzled,
//   K-major, and each stage is four wgmma m64n64k16 (bf16 in, float32
//   accumulate) with both operands in shared memory;
// * split K over a thread-block cluster: the CS ranks of a cluster share
//   one output tile and take equal runs of its (tap, channel chunk)
//   stages.  Each rank leaves its float32 partial in its shared memory;
//   after a cluster barrier rank r sums, for its eighth-to-whole share of
//   the tile's columns, the partials of every rank in rank order (so the
//   result is the same whichever rank sums it) through distributed shared
//   memory, and runs the epilogue on them.  The split CS is chosen by the
//   Python planner (ops/kernels/conv_fused.py) so that each of the small
//   maps gets 128 blocks: 1, 2, 4 and 8 at CIFAR's four shapes;
// * taps that read only padding for every pixel (dy != 0 at H = 1, dx != 0
//   at W = 1) are not among the stages, so the 1x1 map reads the centre
//   tap alone;
// * the epilogue applies scale, bias and ReLU on the accumulator registers,
//   rounds to bf16 into a swizzled staging tile and writes 16-byte vectors
//   (element by element where Cout % 8 != 0), masking pixels outside the
//   image or the batch and channels past Cout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128 + 32;  // a consumer warpgroup + the producer
constexpr int kKC = 64;             // input channels of a stage (128 bytes)
constexpr int kTileBytes = 64 * 128;         // a [64 x 64] bf16 tile
constexpr int kStageBytes = 2 * kTileBytes;  // A (pixels) + B (weights)
constexpr int kStages = 4;
constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
constexpr int kMaxSplit = 8;

struct Args {
  const float* scale;
  const float* bias;
  __nv_bfloat16* y;
  int n, h, w, c, cout;
  int g, th, tw, split;
  int tiles_x, tiles_y, tiles_n;
  int ry, rx, kch, steps;  // steps: stages of one rank
};

__device__ __forceinline__ float affine_relu(float v, float s, float b) {
  v = __fadd_rn(__fmul_rn(v, s), b);
  return v < 0.f ? 0.f : v;
}

__global__ void __launch_bounds__(kThreads)
    conv3x3_bn_relu_kernel(const __grid_constant__ CUtensorMap mx,
                           const __grid_constant__ CUtensorMap mw,
                           const Args a) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  // after the main loop the ring is free: the partial sums (16 KB) at its
  // start, the output staging tile (8 KB) behind them
  float4* partial = reinterpret_cast<float4*>(ring);
  unsigned char* out = ring + 2 * kTileBytes;

  const int rank = (int)(blockIdx.x % a.split);
  const int tile = (int)(blockIdx.x / a.split);
  const int tn = tile % a.tiles_n, tm = tile / a.tiles_n;
  const int x0 = (tm % a.tiles_x) * a.tw;
  const int y0 = (tm / a.tiles_x % a.tiles_y) * a.th;
  const int n0 = tm / (a.tiles_x * a.tiles_y) * a.g;
  const int co0 = tn * 64;
  const int first = rank * a.steps;  // the rank's first (tap, chunk) stage

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // ------------------------- the producer warp
    if (threadIdx.x == 128) {
      const int ntx = 2 * a.rx + 1;
      const uint32_t abytes = (uint32_t)(a.g * a.th * a.tw) * 128;
      for (int k = 0; k < a.steps; ++k) {
        const int s = k % kStages;
        if (k >= kStages) mbar_wait(&empty[s], (k / kStages - 1) & 1);
        const int q = first + k, tap = q / a.kch, ch = q % a.kch;
        const int dy = tap / ntx - a.ry, dx = tap % ntx - a.rx;
        unsigned char* st = ring + s * kStageBytes;
        mbar_expect_tx(&full[s], abytes + kTileBytes);
        tma_load_4d(st, &mx, &full[s], ch * kKC, x0 + dx, y0 + dy, n0);
        tma_load_3d(st + kTileBytes, &mw, &full[s], ch * kKC,
                    (dy + 1) * 3 + dx + 1, co0);
      }
    }
    if (a.split > 1) {  // the cluster barriers count this warp too
      __syncwarp();
      cluster_arrive();
      cluster_wait();
      cluster_arrive();
      cluster_wait();
    }
    return;
  }

  // ------------------------------------------------ the consumer warpgroup
  const int tid = threadIdx.x, warp = tid / 32, g8 = (tid % 32) >> 2,
            t = tid & 3;
  const uint32_t ring_addr = smem_addr(ring);
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;

  int pending = -1;
  for (int k = 0; k < a.steps; ++k) {
    const int s = k % kStages;
    mbar_wait(&full[s], (k / kStages) & 1);
    const uint32_t st = ring_addr + s * kStageBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(acc, desc_sw128(st + kk * 32),
               desc_sw128(st + kTileBytes + kk * 32), 1);
    wgmma_commit();
    wgmma_wait<1>();
    if (pending >= 0 && tid == 0) mbar_arrive(&empty[pending]);
    pending = s;
  }
  wgmma_wait<0>();

  // the 8-column chunks of the tile this rank finishes: all of them, or
  // its share of a split
  const int per = 8 / a.split, j0 = rank * per;
  if (a.split > 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      partial[j * 128 + tid] =
          make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                      acc[4 * j + 3]);
    cluster_arrive();
    cluster_wait();  // every rank's partial is in its shared memory
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < j0 || j >= j0 + per) continue;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < a.split; ++q) {
        const float4 v = ld_cluster_f4(&partial[j * 128 + tid], (uint32_t)q);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      acc[4 * j] = sum.x;
      acc[4 * j + 1] = sum.y;
      acc[4 * j + 2] = sum.z;
      acc[4 * j + 3] = sum.w;
    }
  }

  // epilogue: scale, bias, ReLU, bf16 into the swizzled staging tile
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < j0 || j >= j0 + per) continue;
    const int col = co0 + j * 8 + 2 * t;
    const int c0 = min(col, a.cout - 1), c1 = min(col + 1, a.cout - 1);
    const float s0 = a.scale[c0], s1 = a.scale[c1];
    const float b0 = a.bias[c0], b1 = a.bias[c1];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = warp * 16 + g8 + 8 * h2;
      *reinterpret_cast<uint32_t*>(out + r * 128 + ((j ^ (r & 7)) * 16) +
                                   t * 4) =
          pack_bf16x2(affine_relu(acc[4 * j + 2 * h2], s0, b0),
                      affine_relu(acc[4 * j + 2 * h2 + 1], s1, b1));
    }
  }
  named_barrier(1, 128);
  const int box = a.th * a.tw;
  const bool vec = a.cout % 8 == 0;
  for (int idx = tid; idx < 64 * per; idx += 128) {
    const int r = idx / per, j = j0 + idx % per;
    const int img = n0 + r / box, yy = y0 + r % box / a.tw,
              xx = x0 + r % a.tw;
    const int col = co0 + j * 8;
    if (r >= a.g * box || img >= a.n || yy >= a.h || xx >= a.w ||
        col >= a.cout)
      continue;
    const uint4 v =
        *reinterpret_cast<const uint4*>(out + r * 128 + ((j ^ (r & 7)) * 16));
    __nv_bfloat16* dst =
        a.y + (((size_t)img * a.h + yy) * a.w + xx) * a.cout + col;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
      for (int i = 0; i < 8 && col + i < a.cout; ++i) dst[i] = e[i];
    }
  }
  if (a.split > 1) {  // no rank leaves while another reads its partial
    cluster_arrive();
    cluster_wait();
  }
}

// The weight's tensor map, encoded once per (pointer, C, Cout) and kept:
// the eval forward hands the same weights to every call.
struct WeightMap {
  const void* w;
  int c, cout;
  CUtensorMap map;
};

bool weight_map(const void* w, int c, int cout, CUtensorMap* out) {
  static std::mutex mu;
  static WeightMap cache[64];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (cache[i].w == w && cache[i].c == c && cache[i].cout == cout) {
      *out = cache[i].map;
      return true;
    }
  WeightMap e{w, c, cout, {}};
  const uint64_t dims[3] = {(uint64_t)c, 9, (uint64_t)cout};
  const uint64_t strides[2] = {(uint64_t)c * 2, (uint64_t)c * 18};
  const uint32_t box[3] = {kKC, 1, 64};
  if (!hopper::encode_bf16(&e.map, w, 3, dims, strides, box)) return false;
  cache[next] = e;
  next = (next + 1) % 64;
  if (used < 64) ++used;
  *out = e.map;
  return true;
}

cudaError_t opt_in() {
  static const cudaError_t err = cudaFuncSetAttribute(
      conv3x3_bn_relu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  return err;
}

}  // namespace

// What the Python planner assumes of this kernel, for the card tests to
// hold against it.  out[0..6]: shared-memory bytes a block, ring stages,
// blocks an SM holds at once, SMs of the current device, and clusters of
// 2, 4 and 8 blocks the card holds at once.
extern "C" int mcn_conv3x3_bn_relu_facts(int* out) {
  cudaError_t e = opt_in();
  int dev = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[3], cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], conv3x3_bn_relu_kernel, kThreads, kSmem);
  for (int i = 0; i < 3 && e == cudaSuccess; ++i) {
    const unsigned split = 2u << i;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(split, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = kSmem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaOccupancyMaxActiveClusters(&out[4 + i], conv3x3_bn_relu_kernel,
                                       &cfg);
  }
  out[0] = kSmem;
  out[1] = kStages;
  return (int)e;
}

// g, th, tw: the output tile (G images x TH x TW pixels, at most 64);
// split: the ranks of a cluster that share a tile's K (1, 2, 4 or 8, and a
// divisor of its stage count); both from the Python planner.
extern "C" int mcn_conv3x3_bn_relu(const void* x, const void* wt,
                                   const void* scale, const void* bias,
                                   void* y, int n, int h, int w, int c,
                                   int cout, int g, int th, int tw, int split,
                                   void* stream) {
  if (n < 0 || h <= 0 || w <= 0 || c <= 0 || c % 8 != 0 || cout <= 0 ||
      g <= 0 || th <= 0 || tw <= 0 || th > h || tw > w ||
      g * th * tw > 64 || split < 1 || split > kMaxSplit ||
      (split & (split - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const hopper::DeviceOf dev(x);
  if (dev.error() != cudaSuccess) return (int)dev.error();
  Args a;
  a.ry = h > 1 ? 1 : 0;
  a.rx = w > 1 ? 1 : 0;
  a.kch = (c + kKC - 1) / kKC;
  const int stages = (2 * a.ry + 1) * (2 * a.rx + 1) * a.kch;
  if (stages % split != 0) return (int)cudaErrorInvalidValue;
  a.steps = stages / split;
  a.tiles_x = (w + tw - 1) / tw;
  a.tiles_y = (h + th - 1) / th;
  a.tiles_n = (cout + 63) / 64;
  const long long blocks = (long long)((n + g - 1) / g) * a.tiles_y *
                           a.tiles_x * a.tiles_n * split;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap mx, mw;
  const uint64_t dx[4] = {(uint64_t)c, (uint64_t)w, (uint64_t)h, (uint64_t)n};
  const uint64_t sx[3] = {(uint64_t)c * 2, (uint64_t)w * c * 2,
                          (uint64_t)h * w * c * 2};
  const uint32_t bx[4] = {kKC, (uint32_t)tw, (uint32_t)th, (uint32_t)g};
  if (!hopper::encode_bf16(&mx, x, 4, dx, sx, bx) ||
      !weight_map(wt, c, cout, &mw))
    return (int)cudaErrorInvalidValue;
  const cudaError_t opted = opt_in();
  if (opted != cudaSuccess) return (int)opted;
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.n = n; a.h = h; a.w = w; a.c = c; a.cout = cout;
  a.g = g; a.th = th; a.tw = tw; a.split = split;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, conv3x3_bn_relu_kernel, mx, mw, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
