// The bottleneck pair in one kernel:
//   y = relu(s3 * conv3x3_same(relu(s1 * conv1x1(x) + b1)) + b3)
// with the [N, H, W, Cm] intermediate kept in shared memory.
//
// Replaces the Pallas TPU kernel myconvnet_tpu/ops/pallas/conv_pair.py
// (conv1x1_conv3x3_bn_relu).  Layouts: x [N, H, W, Cin] bf16; w1 [Cm, Cin]
// bf16 (an OIHW 1x1 weight); w3 [Cout, 3, 3, Cm] bf16 (OIHW stored
// channels_last); s1, b1 [Cm] and s3, b3 [Cout] float32; y [N, H, W, Cout]
// bf16.  Accumulation is float32; the intermediate is rounded to bf16 after
// BN1 + ReLU, as the Pallas kernel rounds it into its VMEM scratch.
//
// What bounds it on the H100: at ResNet-50's shapes the pair does
// 2*Cm*(Cin + 9*Cout) flops per pixel against (Cin + Cout) * 2 bytes of
// HBM traffic, some 200-400 flop/byte, near the ridge.  The unfused pair
// also writes and re-reads the intermediate (Cm * 4 bytes a pixel); this
// kernel never sends it to HBM, which is the point of the fusion.  The late
// stages are small (a 7x7 map is one tile per image), so the other bound is
// how many SMs get work: the design splits each tile's channels over a
// thread-block cluster.
//
// Design, kept simple before it is made fast:
// * one cluster of CS blocks = one image x one TH x TW tile of output
//   pixels; block rank r of the cluster owns intermediate channels
//   [r*Cm/CS, (r+1)*Cm/CS) and output channels [r*Cout/CS, (r+1)*Cout/CS);
//   8 warps per block; bf16 WMMA (16x16x16, float32 accumulators);
// * phase 1: the block's slice of the 1x1 conv over the tile plus a
//   one-pixel halo.  The halo grid is flattened row-major with width TW + 2.
//   Cin is streamed through shared memory KC channels at a time, x rows and
//   the matching w1 rows together, with cp.async into two buffers so the
//   next chunk loads while the tensor cores work on this one (pixels outside
//   the image are zero-filled).  Each accumulator tile gets s1, b1 and ReLU,
//   then halo pixels outside the image are set to 0 (SAME padding applies
//   to the intermediate after BN1 + ReLU, not to relu(b1)) and stored bf16;
// * the blocks of the cluster copy each other's slices through distributed
//   shared memory, so every block holds the whole intermediate;
// * phase 2: the block's output channels of the 3x3 conv as nine shifted
//   GEMMs over the flattened halo grid.  Output row r (a halo-grid index)
//   reads intermediate rows r + dy*(TW+2) + dx, so every tap of 16
//   consecutive rows is one WMMA load with a fixed stride.  Rows that fall
//   on halo columns are computed and thrown away (a (TW+2)/TW overhead) in
//   exchange for that regular access.  w3 streams through the same two
//   buffers, KC2 intermediate channels x 9 taps at a time;
// * work is cut into passes of at most 40 accumulator tiles (8 warps x 5):
//   all row tiles times a group of at most 8 channel tiles, so a pass
//   stages only its group's weight rows;
// * the host-side planner picks the tile (TH x TW) and CS: one block per SM
//   at least where the channel counts allow, then whatever makes the
//   shared memory fit.
// Later work: wgmma with TMA-fed stages (and TMA multicast of the x tile,
// which every rank of a cluster reads today).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace cg = cooperative_groups;
using namespace nvcuda;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTilesPerWarp = 5;  // accumulator tiles a warp holds at once
constexpr int kPassTiles = kWarps * kTilesPerWarp;
constexpr int kKC = 64;            // input channels per phase-1 stage
constexpr int kLdX = kKC + 8;      // staged x/w1 row stride (bf16), 144 B
constexpr int kKC2 = 32;           // intermediate channels per phase-2 stage
constexpr int kLdW = 9 * kKC2 + 8; // staged w3 row stride (bf16), 592 B
constexpr int kPadI = 16;          // intermediate row padding (bf16): rows
                                   // 32 B apart mod 128, so WMMA loads
                                   // conflict 2-way, not 8-way, and every
                                   // row stays 32-byte aligned
constexpr int kMaxSmem = 232448;   // 227 KB opt-in limit of sm_90
constexpr int kMaxCluster = 8;     // portable cluster size

constexpr int kMaxPassN = 8;       // channel tiles per pass, at most
// n-tiles (16 channels each) per pass when there are mt row tiles (the
// planner keeps mt <= 10, so mt * n-tiles stays within kPassTiles)
__host__ __device__ inline int pass_ntiles(int mt, int nt) {
  int per = kPassTiles / mt > 0 ? kPassTiles / mt : 1;
  if (per > kMaxPassN) per = kMaxPassN;
  return per < nt ? per : nt;
}

struct Geometry {
  int hw;        // halo-grid width, TW + 2
  int halo;      // (TH + 2) * hw pixels of intermediate per tile
  int rows1;     // halo rounded up to 16 (phase-1 GEMM rows)
  int rows2;     // TH * hw rounded up to 16 (phase-2 GEMM rows)
  int inter;     // intermediate rows held, one slack row before row 0
  int nb1, nb2;  // n-tiles per pass in phase 1 and phase 2
  int buf;       // elements of one staging buffer (two are held)
  size_t smem;   // bytes of dynamic shared memory

  __host__ __device__ Geometry(int th, int tw, int cm, int cmr, int cor) {
    hw = tw + 2;
    halo = (th + 2) * hw;
    rows1 = (halo + 15) / 16 * 16;
    rows2 = (th * hw + 15) / 16 * 16;
    const int need2 = 2 * hw + rows2 + 2;  // last phase-2 read + 1
    inter = rows1 + 1 > need2 ? rows1 + 1 : need2;
    nb1 = pass_ntiles(rows1 / 16, cmr / 16);
    nb2 = pass_ntiles(rows2 / 16, cor / 16);
    const int buf1 = (rows1 + nb1 * 16) * kLdX;
    const int buf2 = nb2 * 16 * kLdW;
    buf = buf1 > buf2 ? buf1 : buf2;
    smem = (size_t)inter * (cm + kPadI) * 2 + (size_t)2 * buf * 2 +
           (size_t)kWarps * 256 * 4;
  }
};

struct Plan {
  int th, tw, cs;
  size_t smem;
};

bool channels_split(int cm, int cout, int cs) {
  return cm % (16 * cs) == 0 && cout % (16 * cs) == 0;
}

// Tile and cluster size for one launch; false if nothing fits.
bool make_plan(int n, int h, int w, int cm, int cout, int sms, Plan* out) {
  int tw = w < 14 ? w : 14;
  int th = 1;
  for (int d = 1; d <= 8; ++d)
    if (h % d == 0) th = d;
  if (th < 4) th = h < 8 ? h : 8;
  for (;;) {
    const long long tiles =
        (long long)n * ((h + th - 1) / th) * ((w + tw - 1) / tw);
    int cs = 1;
    while (cs < kMaxCluster && tiles * cs < sms &&
           channels_split(cm, cout, 2 * cs))
      cs *= 2;
    for (;;) {
      const Geometry g(th, tw, cm, cm / cs, cout / cs);
      if (g.smem <= (size_t)kMaxSmem) {
        *out = Plan{th, tw, cs, g.smem};
        return true;
      }
      if (cs >= kMaxCluster || !channels_split(cm, cout, 2 * cs)) break;
      cs *= 2;
    }
    if (th == 1) return false;
    th = (th + 1) / 2;
  }
}

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w1;
  const float* s1;
  const float* b1;
  const __nv_bfloat16* w3;
  const float* s3;
  const float* b3;
  __nv_bfloat16* y;
  int n, h, w, cin, cm, cout, th, tw, cs, tiles_x, tiles_y;
};

__device__ __forceinline__ float affine_relu(float v, float s, float b) {
  v = __fadd_rn(__fmul_rn(v, s), b);
  return v < 0.f ? 0.f : v;
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__global__ void __launch_bounds__(kThreads)
    conv_pair_kernel(const Args p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cmr = p.cm / p.cs;    // this block's intermediate channels
  const int cor = p.cout / p.cs;  // this block's output channels
  const int ldi = p.cm + kPadI;   // intermediate row stride (bf16)
  const Geometry g(p.th, p.tw, p.cm, cmr, cor);
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* inter = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* stage = inter + (size_t)g.inter * ldi;  // 2 buffers
  float* scratch = reinterpret_cast<float*>(stage + 2 * (size_t)g.buf);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* wscratch = scratch + warp * 256;

  const int tiles = p.tiles_x * p.tiles_y;
  const int item = blockIdx.x / p.cs;  // one cluster per (image, tile)
  const int img = item / tiles;
  const int tile = item % tiles;
  const int ty0 = (tile / p.tiles_x) * p.th;  // first output row of the tile
  const int tx0 = (tile % p.tiles_x) * p.tw;
  const __nv_bfloat16* ximg = p.x + (size_t)img * p.h * p.w * p.cin;
  const int c1 = rank * cmr;  // first intermediate channel of this block

  // zero this block's slice of the intermediate: slack rows and rows past
  // the halo must read as 0 (they feed only outputs that are thrown away,
  // but stay finite)
  for (int i = threadIdx.x; i < g.inter * (cmr / 8); i += kThreads) {
    const int r = i / (cmr / 8), v = i % (cmr / 8);
    *reinterpret_cast<uint4*>(inter + (size_t)r * ldi + c1 + v * 8) =
        make_uint4(0, 0, 0, 0);
  }

  // ---------------- phase 1: 1x1 conv + s1/b1 + ReLU over tile + halo
  const int mt1 = g.rows1 / 16;
  const int nt1 = cmr / 16;
  const int nchunk1 = p.cin / kKC;
  for (int nb0 = 0; nb0 < nt1; nb0 += g.nb1) {
    const int nb = nt1 - nb0 < g.nb1 ? nt1 - nb0 : g.nb1;
    const int ptiles = mt1 * nb;  // tile u: row tile u % mt1, n-tile u / mt1
    // x rows [0, rows1) then w1 rows of this pass's channels
    auto load = [&](int c, int b) {
      __nv_bfloat16* dst = stage + (size_t)b * g.buf;
      const int k0 = c * kKC;
      for (int i = threadIdx.x; i < (g.rows1 + nb * 16) * (kKC / 8);
           i += kThreads) {
        const int r = i / (kKC / 8), v = i % (kKC / 8);
        const __nv_bfloat16* src = p.w1;  // any valid address for a fill
        int fill = 16;
        if (r < g.rows1) {
          const int gy = ty0 - 1 + r / g.hw, gx = tx0 - 1 + r % g.hw;
          if (r < g.halo && gy >= 0 && gy < p.h && gx >= 0 && gx < p.w) {
            src = ximg + ((size_t)gy * p.w + gx) * p.cin + k0 + v * 8;
            fill = 0;
          }
        } else {
          src = p.w1 + (size_t)(c1 + nb0 * 16 + r - g.rows1) * p.cin + k0 +
                v * 8;
          fill = 0;
        }
        __pipeline_memcpy_async(dst + r * kLdX + v * 8, src, 16, fill);
      }
      __pipeline_commit();
    };
    FragC acc[kTilesPerWarp];
#pragma unroll
    for (int f = 0; f < kTilesPerWarp; ++f) wmma::fill_fragment(acc[f], 0.f);
    __syncthreads();  // the staging buffers are free
    load(0, 0);
    for (int c = 0; c < nchunk1; ++c) {
      if (c + 1 < nchunk1) {
        load(c + 1, (c + 1) & 1);
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();  // chunk c is in shared memory
      const __nv_bfloat16* xb = stage + (size_t)(c & 1) * g.buf;
      const __nv_bfloat16* wb = xb + g.rows1 * kLdX;
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16) {
        FragA a[kTilesPerWarp];
        FragB b[kTilesPerWarp];
#pragma unroll
        for (int f = 0; f < kTilesPerWarp; ++f) {
          const int u = warp + kWarps * f;
          if (u < ptiles) {
            wmma::load_matrix_sync(a[f], xb + (u % mt1) * 16 * kLdX + kk,
                                   kLdX);
            wmma::load_matrix_sync(b[f], wb + (u / mt1) * 16 * kLdX + kk,
                                   kLdX);
          }
        }
#pragma unroll
        for (int f = 0; f < kTilesPerWarp; ++f)
          if (warp + kWarps * f < ptiles)
            wmma::mma_sync(acc[f], a[f], b[f], acc[f]);
      }
      __syncthreads();  // done with buffer c & 1 before it is refilled
    }
#pragma unroll
    for (int f = 0; f < kTilesPerWarp; ++f) {
      const int u = warp + kWarps * f;
      if (u < ptiles) {
        const int m = u % mt1, nt = nb0 + u / mt1;
        wmma::store_matrix_sync(wscratch, acc[f], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = m * 16 + e / 16;
          const int ch = c1 + nt * 16 + e % 16;
          const int gy = ty0 - 1 + r / g.hw;
          const int gx = tx0 - 1 + r % g.hw;
          const bool inside = r < g.halo && gy >= 0 && gy < p.h && gx >= 0 &&
                              gx < p.w;
          const float v = inside ? affine_relu(wscratch[e], p.s1[ch], p.b1[ch])
                                 : 0.f;
          inter[(size_t)(r + 1) * ldi + ch] = __float2bfloat16_rn(v);
        }
        __syncwarp();
      }
    }
  }

  // ---------------- gather the other ranks' slices (distributed smem)
  cluster.sync();  // every slice of the cluster is complete
  for (int q = 1; q < p.cs; ++q) {
    const int src = (rank + q) % p.cs;
    const __nv_bfloat16* remote = cluster.map_shared_rank(inter, src);
    for (int i = threadIdx.x; i < g.inter * (cmr / 8); i += kThreads) {
      const size_t off =
          (size_t)(i / (cmr / 8)) * ldi + src * cmr + (i % (cmr / 8)) * 8;
      *reinterpret_cast<uint4*>(inter + off) =
          *reinterpret_cast<const uint4*>(remote + off);
    }
  }
  __syncthreads();  // the whole intermediate is local

  // ---------------- phase 2: 3x3 conv as nine shifted GEMMs + s3/b3 + ReLU
  const int mt2 = g.rows2 / 16;
  const int nt2 = cor / 16;
  const int nchunk2 = p.cm / kKC2;
  const size_t ldw3 = (size_t)9 * p.cm;
  for (int nb0 = 0; nb0 < nt2; nb0 += g.nb2) {
    const int nb = nt2 - nb0 < g.nb2 ? nt2 - nb0 : g.nb2;
    const int ptiles = mt2 * nb;
    const __nv_bfloat16* w3p = p.w3 + (size_t)(rank * cor + nb0 * 16) * ldw3;
    // w3 rows of this pass: [output channel][tap][KC2 channels]
    auto load = [&](int c, int b) {
      __nv_bfloat16* dst = stage + (size_t)b * g.buf;
      const int k0 = c * kKC2;
      constexpr int kVec = kKC2 / 8;
      for (int i = threadIdx.x; i < nb * 16 * 9 * kVec; i += kThreads) {
        const int row = i / (9 * kVec), rem = i % (9 * kVec);
        const int tap = rem / kVec, v = rem % kVec;
        __pipeline_memcpy_async(
            dst + row * kLdW + tap * kKC2 + v * 8,
            w3p + (size_t)row * ldw3 + tap * p.cm + k0 + v * 8, 16);
      }
      __pipeline_commit();
    };
    FragC acc[kTilesPerWarp];
#pragma unroll
    for (int f = 0; f < kTilesPerWarp; ++f) wmma::fill_fragment(acc[f], 0.f);
    __syncthreads();  // the staging buffers are free
    load(0, 0);
    for (int c = 0; c < nchunk2; ++c) {
      if (c + 1 < nchunk2) {
        load(c + 1, (c + 1) & 1);
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();  // chunk c is in shared memory
      const __nv_bfloat16* wb = stage + (size_t)(c & 1) * g.buf;
      for (int tap = 0; tap < 9; ++tap) {
        // stored row of intermediate pixel r is r + 1; output rows start
        // at halo-grid row hw (the first interior row)
        const int shift = g.hw + 1 + (tap / 3 - 1) * g.hw + (tap % 3 - 1);
#pragma unroll
        for (int kk = 0; kk < kKC2; kk += 16) {
          FragA a[kTilesPerWarp];
          FragB b[kTilesPerWarp];
#pragma unroll
          for (int f = 0; f < kTilesPerWarp; ++f) {
            const int u = warp + kWarps * f;
            if (u < ptiles) {
              wmma::load_matrix_sync(
                  a[f],
                  inter + (size_t)((u % mt2) * 16 + shift) * ldi +
                      c * kKC2 + kk,
                  ldi);
              wmma::load_matrix_sync(
                  b[f], wb + (u / mt2) * 16 * kLdW + tap * kKC2 + kk, kLdW);
            }
          }
#pragma unroll
          for (int f = 0; f < kTilesPerWarp; ++f)
            if (warp + kWarps * f < ptiles)
              wmma::mma_sync(acc[f], a[f], b[f], acc[f]);
        }
      }
      __syncthreads();  // done with buffer c & 1 before it is refilled
    }
#pragma unroll
    for (int f = 0; f < kTilesPerWarp; ++f) {
      const int u = warp + kWarps * f;
      if (u < ptiles) {
        const int m = u % mt2, nt = nb0 + u / mt2;
        wmma::store_matrix_sync(wscratch, acc[f], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int q = m * 16 + e / 16;  // output index on the halo grid
          const int oy = q / g.hw;        // (row 0 = first interior row)
          const int ox = q % g.hw - 1;
          const int gy = ty0 + oy, gx = tx0 + ox;
          if (oy < p.th && ox >= 0 && ox < p.tw && gy < p.h && gx < p.w) {
            const int ch = rank * cor + nt * 16 + e % 16;
            const float v = affine_relu(wscratch[e], p.s3[ch], p.b3[ch]);
            p.y[(((size_t)img * p.h + gy) * p.w + gx) * p.cout + ch] =
                __float2bfloat16_rn(v);
          }
        }
        __syncwarp();
      }
    }
  }
  cluster.sync();  // no block leaves while another may read its slice
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

bool valid_shape(int n, int h, int w, int cin, int cm, int cout) {
  return n >= 1 && h >= 1 && w >= 1 && cin % kKC == 0 && cin > 0 &&
         cm % kKC2 == 0 && cm > 0 && cout % 16 == 0 && cout > 0;
}

}  // namespace

// The launch plan for a shape: out = {TH, TW, CS, shared-memory bytes}.
extern "C" int mcn_conv_pair_plan(int n, int h, int w, int cin, int cm,
                                  int cout, int* out) {
  Plan plan;
  if (!valid_shape(n, h, w, cin, cm, cout) ||
      !make_plan(n, h, w, cm, cout, sm_count(), &plan))
    return (int)cudaErrorInvalidValue;
  out[0] = plan.th;
  out[1] = plan.tw;
  out[2] = plan.cs;
  out[3] = (int)plan.smem;
  return 0;
}

extern "C" int mcn_conv_pair(const void* x, const void* w1, const void* s1,
                             const void* b1, const void* w3, const void* s3,
                             const void* b3, void* y, int n, int h, int w,
                             int cin, int cm, int cout, void* stream) {
  Plan plan;
  if (!valid_shape(n, h, w, cin, cm, cout) ||
      !make_plan(n, h, w, cm, cout, sm_count(), &plan))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)plan.smem);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w1 = static_cast<const __nv_bfloat16*>(w1);
  a.s1 = static_cast<const float*>(s1);
  a.b1 = static_cast<const float*>(b1);
  a.w3 = static_cast<const __nv_bfloat16*>(w3);
  a.s3 = static_cast<const float*>(s3);
  a.b3 = static_cast<const float*>(b3);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.n = n; a.h = h; a.w = w; a.cin = cin; a.cm = cm; a.cout = cout;
  a.th = plan.th; a.tw = plan.tw; a.cs = plan.cs;
  a.tiles_x = (w + plan.tw - 1) / plan.tw;
  a.tiles_y = (h + plan.th - 1) / plan.th;
  const long long blocks = (long long)n * a.tiles_x * a.tiles_y * plan.cs;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)plan.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, conv_pair_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
