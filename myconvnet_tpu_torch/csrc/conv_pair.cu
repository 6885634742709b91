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
// HBM traffic plus the weights once, some 200-400 flop/byte, near the
// ridge: the tensor cores at three of the five sites, HBM at the other two.
// The unfused pair also writes and re-reads the intermediate (Cm * 4 bytes
// a pixel); this kernel never sends it to HBM.  What holds a fused kernel
// back in practice is the rest: the late stages have few pixels and large
// weights (w3 is 4.7 MB at 7x7), so filling 132 SMs means splitting each
// tile's channels over a cluster, and each block streams its weight slice
// from L2 at a rate the tensor cores could outrun.
//
// Design, built from Hopper's parts:
// * one cluster of CS blocks = one image x one TH x TW tile of output
//   pixels; rank r of the cluster owns intermediate channels
//   [r*Cm/CS, (r+1)*Cm/CS) and output channels [r*Cout/CS, (r+1)*Cout/CS).
//   The planner picks CS for at least 7/8 of a block per SM where the
//   channel counts allow, then the smallest tile whose clusters the card
//   runs all at once: one wave, even where that leaves SMs idle (at batch
//   8, 128 blocks at 56x56 and 28x28, 96 at 14x14 and 64 at 7x7 on 132
//   SMs), since a second wave costs more;
// * a block is two consumer warpgroups and one producer warp.  The
//   producer's lane 0 keeps a ring of 3-4 stages full by TMA
//   (cp.async.bulk.tensor, completion on each stage's "full" mbarrier, the
//   consumers release a stage on its "empty" mbarrier): in phase 1 a stage
//   is 64 input channels of the x halo tile, through a 4-D tensor map over
//   NHWC x whose box starts at (ty0 - 1, tx0 - 1), so TMA's zero fill gives
//   the SAME halo, and the matching w1 rows; in phase 2 a stage is 64
//   intermediate channels of one row of three taps of w3.  All tiles land
//   128-byte swizzled.  Weight maps are encoded once per weight and shape and
//   cached; x's is encoded per launch;
// * every product is wgmma m64n64k16 (bf16 in, float32 accumulate), a
//   warpgroup holding up to four 64x64 accumulator tiles; a pass covers up
//   to eight tiles (all row tiles times a group of 64-channel column
//   chunks).  Every tile sums its K steps in one order, whatever the
//   launch geometry, so an image's output does not depend on the tile, the
//   cluster or the batch it was launched with: a pass of a single tile
//   runs on one warpgroup while the other only releases the stages
//   (sharing its K steps between the two, and adding the two sums, would
//   round another way);
// * phase 1: the 1x1 conv of the rank's channel slice over the tile plus a
//   one-pixel halo, the halo grid flattened row-major with width TW + 2.
//   The epilogue runs on the accumulator registers: s1, b1, ReLU, zero for
//   halo pixels outside the image (SAME padding applies to the intermediate
//   after BN1 + ReLU, not to relu(b1)), bf16, straight into shared memory;
// * phase 2 reads the intermediate at shifted rows: output row q of the
//   halo grid takes row q + ty*(TW+2) + tx for tap (ty, tx), and a shift of
//   one pixel breaks the 8-row, 1024-byte atoms of a swizzled wgmma
//   operand.  So the intermediate is stored in the no-swizzle core-matrix
//   layout, channel-group-major: group g of eight channels is all rows x 16
//   bytes, so any eight consecutive rows form a core matrix (SBO = 128 B,
//   LBO = rows x 16 B) and a shifted operand is just a start address 16
//   bytes times the shift further on.  A core matrix is 128 contiguous
//   bytes, so by this reasoning (not measured: the card's profilers are
//   out of reach) the tensor cores read it without bank conflicts, and the
//   epilogue's stores (eight rows of 16 bytes a warp) meet none either.  Rows
//   that fall on halo columns are computed and thrown away (a (TW+2)/TW
//   overhead) in exchange for that regular access;
// * between the phases the ranks pull each other's slices through
//   distributed shared memory (a slice is one contiguous block in this
//   layout), between two cluster barriers;
// * phase 2: the rank's output channels as nine shifted GEMMs; its
//   epilogue applies s3, b3 and ReLU on the registers, rounds to bf16,
//   stages the tile in shared memory and writes it with 16-byte stores.
//
// Left for later: TMA multicast of the x tile, which every rank of a
// cluster reads from L2 today, and a persistent grid.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kConsumers = 2;                     // warpgroups
constexpr int kThreads = kConsumers * 128 + 32;   // + the producer warp
constexpr int kKC = 64;          // channels of one K step (a 128-byte row)
constexpr int kTaps2 = 3;        // taps of w3 a phase-2 stage brings (a row)
constexpr int kHeld = 4;         // 64x64 accumulator tiles a warpgroup holds
constexpr int kPassTiles = kConsumers * kHeld;
constexpr int kTileBytes = 64 * 128;              // a [64 x 64] bf16 tile
constexpr int kOutBytes = kConsumers * kTileBytes;  // output staging
constexpr int kMaxSmem = 232448;                  // 227 KB opt-in limit
constexpr int kMaxCluster = 8;                    // portable cluster size

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Everything the kernel and the planner derive from a tile and the
// channel slices; computed on the host and passed to the kernel.
struct Geometry {
  int th, tw, cs;
  int hw;          // halo-grid width, TW + 2
  int halo;        // (TH + 2) * hw pixels of intermediate per tile
  int mt1, mt2;    // 64-row tiles of phase 1 (halo) and phase 2 (outputs)
  int cmr, cor;    // the block's intermediate and output channels
  int nrow1, nrow2;  // weight rows a TMA box brings, min(64, slice)
  int nc1, nc2;    // 64-column chunks of the slices
  int nb1, nb2;    // chunks a pass covers
  int cmp;         // Cm rounded up to 64
  int rows;        // intermediate rows held: one slack row, then the halo
  int xbytes;      // the x tile of a phase-1 stage
  int w3bytes;     // one tap's w3 rows in a phase-2 stage
  int stage;       // bytes of one ring stage
  int stages;      // 3 or 4
  int inter;       // bytes of the intermediate
  int smem;        // dynamic shared memory, 1024 bytes of alignment slack
                   // and the barriers included

  Geometry() = default;
  Geometry(int th_, int tw_, int cs_, int cm, int cout, int pass_cap) {
    th = th_; tw = tw_; cs = cs_;
    hw = tw + 2;
    halo = (th + 2) * hw;
    mt1 = round_up(halo, 64) / 64;
    mt2 = round_up(th * hw, 64) / 64;
    cmr = cm / cs;
    cor = cout / cs;
    nrow1 = imin(64, cmr);
    nrow2 = imin(64, cor);
    nc1 = (cmr + 63) / 64;
    nc2 = (cor + 63) / 64;
    nb1 = imin(nc1, imax(1, imin(pass_cap, kPassTiles) / mt1));
    nb2 = imin(nc2, imax(1, imin(pass_cap, kPassTiles) / mt2));
    cmp = round_up(cm, 64);
    // last phase-2 read: row mt2 * 64 - 1 + 2 * hw + 2 (stored index)
    rows = imax(mt1 * 64 + 1, mt2 * 64 + 2 * hw + 2);
    xbytes = mt1 * kTileBytes;
    // a 64-row read of the last chunk stays inside the stage
    const int w1b = ((nb1 - 1) * nrow1 + 64) * 128;
    w3bytes = ((nb2 - 1) * nrow2 + 64) * 128;
    stage = round_up(imax(xbytes + w1b, kTaps2 * w3bytes), 1024);
    inter = round_up(rows * cmp * 2, 1024);
    stages = 4;
    smem = size(4);
    if (smem > kMaxSmem) {
      stages = 3;
      smem = size(3);
    }
  }
  int size(int st) const {
    return 1024 + inter + st * stage + kOutBytes + 16 * 8;
  }
  bool fits() const { return smem <= kMaxSmem && mt1 <= kPassTiles; }
};

bool channels_split(int cm, int cout, int cs) {
  return cm % (16 * cs) == 0 && cout % (16 * cs) == 0;
}

long long tiles_of(int n, int h, int w, int th, int tw) {
  return (long long)n * ((h + th - 1) / th) * ((w + tw - 1) / tw);
}

struct Args {
  const float* s1;
  const float* b1;
  const float* s3;
  const float* b3;
  __nv_bfloat16* y;
  int h, w, cin, cout, tiles_x, tiles_y;
  Geometry g;
};

__device__ __forceinline__ float affine_relu(float v, float s, float b) {
  v = __fadd_rn(__fmul_rn(v, s), b);
  return v < 0.f ? 0.f : v;
}

// What a consumer thread knows of its block: where things are in shared
// memory, its warpgroup and lane, the block's tile and channel slices.
struct Block {
  unsigned char* inter;  // the intermediate (no swizzle, group-major)
  unsigned char* out;    // output staging
  uint32_t inter_addr, ring_addr;
  uint64_t* full;
  uint64_t* empty;
  int wg, tid, warp, g8, t;
  int img, ty0, tx0, c1, co0;
  int steps1, nch2, steps2;
  int rs;  // bytes of one 8-channel group of the intermediate
};

// Phase 1's epilogue for the 64x64 tile (row tile m, column chunk nl):
// s1, b1, ReLU, zero outside the image, bf16, into the intermediate
__device__ __forceinline__ void epilogue1(const Block& B, const Args& a,
                                          const float (&acc)[32], int m,
                                          int nl) {
  const Geometry& g = a.g;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = m * 64 + B.warp * 16 + B.g8 + 8 * h2;  // halo-grid row
    const int gy = B.ty0 - 1 + r / g.hw, gx = B.tx0 - 1 + r % g.hw;
    const bool inside =
        r < g.halo && gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = nl * 64 + jj * 8 + 2 * B.t;
      if (col >= g.cmr) continue;
      const int ch = B.c1 + col;
      const float v0 =
          inside ? affine_relu(acc[4 * jj + 2 * h2], a.s1[ch], a.b1[ch])
                 : 0.f;
      const float v1 = inside ? affine_relu(acc[4 * jj + 2 * h2 + 1],
                                            a.s1[ch + 1], a.b1[ch + 1])
                              : 0.f;
      *reinterpret_cast<uint32_t*>(B.inter + (ch / 8) * B.rs + (r + 1) * 16 +
                                   (ch % 8) * 2) = hopper::pack_bf16x2(v0, v1);
    }
  }
}

// Phase 2's epilogue for the 64x64 tile (row tile m, column chunk nl): s3,
// b3, ReLU and bf16 on the registers into the warpgroup's swizzled staging
// tile, then 16-byte stores of the rows that are output pixels
__device__ __forceinline__ void epilogue2(const Block& B, const Args& a,
                                          const float (&acc)[32], int m,
                                          int nl) {
  const Geometry& g = a.g;
  unsigned char* stage = B.out + B.wg * kTileBytes;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = B.warp * 16 + B.g8 + 8 * h2;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = nl * 64 + jj * 8 + 2 * B.t;
      uint32_t v = 0;
      if (col < g.cor) {
        const int ch = B.co0 + col;
        v = hopper::pack_bf16x2(
            affine_relu(acc[4 * jj + 2 * h2], a.s3[ch], a.b3[ch]),
            affine_relu(acc[4 * jj + 2 * h2 + 1], a.s3[ch + 1],
                        a.b3[ch + 1]));
      }
      *reinterpret_cast<uint32_t*>(stage + r * 128 + ((jj ^ (r & 7)) * 16) +
                                   B.t * 4) = v;
    }
  }
  hopper::named_barrier(5 + B.wg, 128);
  for (int idx = B.tid; idx < 64 * 8; idx += 128) {
    const int r = idx / 8, chunk = idx % 8;
    const int q = m * 64 + r;  // output index on the halo grid
    const int oy = q / g.hw, ox = q % g.hw - 1;
    const int col = nl * 64 + chunk * 8;
    const int gy = B.ty0 + oy, gx = B.tx0 + ox;
    if (oy < g.th && ox >= 0 && ox < g.tw && gy < a.h && gx < a.w &&
        col < g.cor)
      *reinterpret_cast<uint4*>(
          a.y + (((size_t)B.img * a.h + gy) * a.w + gx) * a.cout + B.co0 +
          col) = *reinterpret_cast<const uint4*>(stage + r * 128 +
                                                 ((chunk ^ (r & 7)) * 16));
  }
  hopper::named_barrier(5 + B.wg, 128);
}

// One pass of a phase for one warpgroup: NT 64x64 accumulator tiles (tile u
// = wg + 2 i of the pass; a warpgroup with fewer real tiles repeats the
// last one and drops it, and one with none only releases the stages).
// Every wgmma of a stage is issued unconditionally; a stage is released
// once the wgmmas that read it have completed (one group kept in flight).
template <int PHASE, int NT>
__device__ __forceinline__ void pass(const Block& B, const Args& a, int n0,
                                     int units, int& j) {
  using namespace hopper;
  const Geometry& g = a.g;
  const int mt = PHASE == 1 ? g.mt1 : g.mt2;
  const int nrow = PHASE == 1 ? g.nrow1 : g.nrow2;
  const int steps = PHASE == 1 ? B.steps1 : B.steps2;
  if (B.wg >= units) {
    // no tile (only warpgroup 1, in a pass of one tile): release each
    // stage once it has filled, after the warpgroup has met, so that no
    // warp still waits for a fill that the release lets the producer
    // overwrite
    for (int k = 0; k < steps; ++k, ++j) {
      const int s = j % g.stages;
      mbar_wait(&B.full[s], (j / g.stages) & 1);
      named_barrier(3, 128);
      if (B.tid == 0) mbar_arrive(&B.empty[s]);
    }
    return;
  }
  uint32_t aoff[NT], boff[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int u = imin(B.wg + kConsumers * i, units - 1);
    aoff[i] = PHASE == 1 ? (u % mt) * kTileBytes : (u % mt) * 64 * 16;
    boff[i] = (PHASE == 1 ? g.xbytes : 0) + (u / mt) * nrow * 128;
  }
  float acc[NT][32];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[i][e] = 0.f;

  int pending = -1;
  for (int k = 0; k < steps; ++k, ++j) {
    const int s = j % g.stages;
    mbar_wait(&B.full[s], (j / g.stages) & 1);
    const uint32_t st = B.ring_addr + s * g.stage;
    wgmma_fence();
    if constexpr (PHASE == 1) {
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(acc[i], desc_sw128(st + aoff[i] + kk * 32),
                   desc_sw128(st + boff[i] + kk * 32), 1);
    } else {
      // taps (ty, 0..2) of intermediate channels [64 c, 64 c + 64): output
      // row q reads stored row q + ty * hw + tx
      const int ty = k / B.nch2, c = k % B.nch2;
      const uint32_t abase =
          B.inter_addr + c * 8 * B.rs + ty * g.hw * 16;
#pragma unroll
      for (int tx = 0; tx < kTaps2; ++tx)
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss(acc[i],
                     desc_plain(abase + aoff[i] + tx * 16 + kk * 2 * B.rs,
                                B.rs, 128),
                     desc_sw128(st + tx * g.w3bytes + boff[i] + kk * 32),
                     1);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (pending >= 0 && B.tid == 0) mbar_arrive(&B.empty[pending]);
    pending = s;
  }
  wgmma_wait<0>();
  if (pending >= 0 && B.tid == 0) mbar_arrive(&B.empty[pending]);

#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int u = B.wg + kConsumers * i;
    if (u >= units) continue;
    if constexpr (PHASE == 1)
      epilogue1(B, a, acc[i], u % mt, n0 + u / mt);
    else
      epilogue2(B, a, acc[i], u % mt, n0 + u / mt);
  }
}

// A pass with its tile count made a compile-time shape
template <int PHASE>
__device__ __forceinline__ void run_pass(const Block& B, const Args& a,
                                         int n0, int units, int& j) {
  switch ((units + 1) / 2) {
    case 1: pass<PHASE, 1>(B, a, n0, units, j); break;
    case 2: pass<PHASE, 2>(B, a, n0, units, j); break;
    case 3: pass<PHASE, 3>(B, a, n0, units, j); break;
    default: pass<PHASE, 4>(B, a, n0, units, j); break;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    conv_pair_kernel(const __grid_constant__ CUtensorMap mx,
                     const __grid_constant__ CUtensorMap mw1,
                     const __grid_constant__ CUtensorMap mw3, const Args a) {
  using namespace hopper;
  const Geometry& g = a.g;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* inter = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = inter + g.inter;
  unsigned char* out = ring + g.stages * g.stage;
  uint64_t* full = reinterpret_cast<uint64_t*>(out + kOutBytes);
  uint64_t* empty = full + g.stages;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tiles = a.tiles_x * a.tiles_y;
  const int item = blockIdx.x / g.cs;  // one cluster per (image, tile)
  const int img = item / tiles;
  const int tile = item % tiles;
  const int ty0 = (tile / a.tiles_x) * g.th;  // first output row of the tile
  const int tx0 = (tile % a.tiles_x) * g.tw;
  const int c1 = rank * g.cmr;   // first intermediate channel of the block
  const int co0 = rank * g.cor;  // first output channel of the block

  const int steps1 = a.cin / kKC, passes1 = (g.nc1 + g.nb1 - 1) / g.nb1;
  const int nch2 = g.cmp / kKC, steps2 = 9 / kTaps2 * nch2;
  const int passes2 = (g.nc2 + g.nb2 - 1) / g.nb2;
  const int total1 = passes1 * steps1, total2 = passes2 * steps2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ------------------------------------------------ the producer warp
    const bool lead = threadIdx.x % 32 == 0;
    auto issue = [&](int j) {
      const int s = j % g.stages;
      if (j >= g.stages) mbar_wait(&empty[s], (j / g.stages - 1) & 1);
      unsigned char* st = ring + s * g.stage;
      if (j < total1) {
        const int c = j % steps1, n0 = (j / steps1) * g.nb1;
        const int nb = imin(g.nb1, g.nc1 - n0);
        mbar_expect_tx(&full[s], (g.halo + nb * g.nrow1) * 128);
        tma_load_4d(st, &mx, &full[s], c * kKC, tx0 - 1, ty0 - 1, img);
        for (int q = 0; q < nb; ++q)
          tma_load_2d(st + g.xbytes + q * g.nrow1 * 128, &mw1, &full[s],
                      c * kKC, c1 + (n0 + q) * 64);
      } else {
        // a row of three taps of 64 intermediate channels
        const int k = j - total1, r = k % steps2;
        const int n0 = (k / steps2) * g.nb2;
        const int nb = imin(g.nb2, g.nc2 - n0);
        mbar_expect_tx(&full[s], kTaps2 * nb * g.nrow2 * 128);
        for (int tap = 0; tap < kTaps2; ++tap)
          for (int q = 0; q < nb; ++q)
            tma_load_3d(st + tap * g.w3bytes + q * g.nrow2 * 128, &mw3,
                        &full[s], (r % nch2) * kKC, (r / nch2) * kTaps2 + tap,
                        co0 + (n0 + q) * 64);
      }
    };
    // The cluster barriers count every thread.  This warp arrives at the
    // first before it loads anything and at the second only once the
    // first has completed, and it never waits on a stage that phase 2
    // frees before it has arrived at the second.
    cluster_arrive();
    const int early = total1 + imin(g.stages, total2);
    if (lead)
      for (int j = 0; j < early; ++j) issue(j);
    __syncwarp();
    cluster_wait();
    cluster_arrive();
    if (lead)
      for (int j = early; j < total1 + total2; ++j) issue(j);
    __syncwarp();
    cluster_wait();
    return;
  }

  // ---------------------------------------------------- the consumers
  Block B;
  B.inter = inter;
  B.out = out;
  B.inter_addr = smem_addr(inter);
  B.ring_addr = smem_addr(ring);
  B.full = full;
  B.empty = empty;
  B.wg = wg;
  B.tid = threadIdx.x % 128;
  B.warp = B.tid / 32;
  B.g8 = (B.tid % 32) >> 2;
  B.t = B.tid & 3;
  B.img = img;
  B.ty0 = ty0;
  B.tx0 = tx0;
  B.c1 = c1;
  B.co0 = co0;
  B.steps1 = steps1;
  B.nch2 = nch2;
  B.steps2 = steps2;
  B.rs = g.rows * 16;

  // zero the intermediate: the slack row, rows past the halo and the
  // channels past Cm are read (as zeros) by outputs that are thrown away
  for (int i = threadIdx.x; i < g.inter / 16; i += kConsumers * 128)
    reinterpret_cast<uint4*>(inter)[i] = make_uint4(0, 0, 0, 0);
  named_barrier(1, kConsumers * 128);

  int j = 0;  // the ring's step count, as the producer's
  // ---------------- phase 1: 1x1 conv + s1/b1 + ReLU over tile + halo
  for (int p = 0; p < passes1; ++p) {
    const int n0 = p * g.nb1;
    run_pass<1>(B, a, n0, g.mt1 * imin(g.nb1, g.nc1 - n0), j);
  }

  // ---------------- the other ranks' slices, through distributed smem
  cluster_arrive();
  cluster_wait();  // every slice of the cluster is complete
  {
    const int slice = g.cmr / 8 * B.rs;  // bytes of one rank's groups
    for (int q = 1; q < g.cs; ++q) {
      const int src = (rank + q) % g.cs;
      const uint4* remote = reinterpret_cast<const uint4*>(
          cluster.map_shared_rank(inter + src * slice, src));
      uint4* local = reinterpret_cast<uint4*>(inter + src * slice);
      for (int i = threadIdx.x; i < slice / 16; i += kConsumers * 128)
        local[i] = remote[i];
    }
  }
  fence_proxy_async();  // generic writes -> wgmma operands
  cluster_arrive();
  cluster_wait();  // the whole intermediate is local; no remote reads after

  // ---------------- phase 2: 3x3 conv as nine shifted GEMMs + s3/b3 + ReLU
  for (int p = 0; p < passes2; ++p) {
    const int n0 = p * g.nb2;
    run_pass<2>(B, a, n0, g.mt2 * imin(g.nb2, g.nc2 - n0), j);
  }
}

// The first geometry of a tile and cluster size whose shared memory fits,
// narrowing the pass until it does; false if none does.
bool fitting(int th, int tw, int cs, int cm, int cout, Geometry* out) {
  for (int cap = kPassTiles; cap >= 1; cap /= 2) {
    const Geometry g(th, tw, cs, cm, cout, cap);
    if (g.fits()) {
      *out = g;
      return true;
    }
  }
  return false;
}

// Lets the kernel take the most shared memory a block can have, once; the
// runtime's answer.
cudaError_t opt_in() {
  static const cudaError_t err = cudaFuncSetAttribute(
      conv_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  return err;
}

// How many clusters of cs blocks the card runs at once when each block
// takes the most shared memory a block may have (0 if the runtime cannot
// say): a floor for any plan, whose blocks take as much or less.  Asked
// once per cluster size.
int active_clusters(int cs) {
  static std::mutex mu;
  static int known[kMaxCluster + 1] = {};  // cs -> count + 1, 0 unknown
  std::lock_guard<std::mutex> lock(mu);
  if (known[cs] == 0) {
    int n = 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)cs, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = kMaxSmem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (opt_in() != cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&n, conv_pair_kernel, &cfg) !=
            cudaSuccess) {
      cudaGetLastError();  // the query's own error, not a launch's
      n = 0;
    }
    known[cs] = n + 1;
  }
  return known[cs] - 1;
}

// Tile, cluster size and pass width for one launch; false if nothing fits.
// The cluster first: grow it while the grid has fewer blocks than 7/8 of
// the SMs and each rank keeps 64 channels of both slices (a wgmma is 64
// columns wide, so a narrower slice saves no work).  Then the tile's
// height: the most rows of tiles whose clusters the card runs all at once.
// A block takes most of an SM's shared memory, so the card holds 132, 66,
// 30 or 15 clusters of 1, 2, 4 or 8 blocks (H100), and a second wave of
// clusters costs more than the SMs the first leaves idle: on the H100 the
// grids of 132 blocks or more that the sites allow ran 1.4-1.8x slower
// than this plan.  Then shared memory: a narrower pass, a larger cluster,
// a smaller tile.
bool make_plan(int n, int h, int w, int cm, int cout, int sms,
               Geometry* out) {
  int tw = w < 14 ? w : 14;
  int th = 1;
  for (int d = 1; d <= 8; ++d)
    if (h % d == 0) th = d;
  if (th < 4) th = h < 8 ? h : 8;
  const long long want = (long long)sms * 7 / 8;
  const long long tiles = tiles_of(n, h, w, th, tw);
  int cs = 1;
  while (cs < kMaxCluster && tiles * cs < want &&
         channels_split(cm, cout, 2 * cs) && cm / (2 * cs) >= 64 &&
         cout / (2 * cs) >= 64)
    cs *= 2;
  // a row of tiles is n * tiles_x clusters; where not even one row fits in
  // a wave, th stays as it is
  long long rows = active_clusters(cs) / ((long long)n * ((w + tw - 1) / tw));
  if (rows > h) rows = h;
  if (rows >= 1) th = (int)((h + rows - 1) / rows);
  for (;;) {
    if (fitting(th, tw, cs, cm, cout, out)) return true;
    if (cs < kMaxCluster && channels_split(cm, cout, 2 * cs)) {
      cs *= 2;
    } else if (th > 1) {
      th = (th + 1) / 2;
    } else if (tw > 1) {
      tw = (tw + 1) / 2;
    } else {
      return false;
    }
  }
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
         cm % 32 == 0 && cm > 0 && cm <= 512 && cout % 16 == 0 && cout > 0;
}

// The geometry of a launch: the planner's, or with th > 0 the caller's
// tile TH x TW over clusters of CS blocks (to measure other plans); false
// for a shape or a tile the kernel cannot run.
bool geometry(int n, int h, int w, int cin, int cm, int cout, int th, int tw,
              int cs, Geometry* g) {
  if (!valid_shape(n, h, w, cin, cm, cout)) return false;
  if (th <= 0) return make_plan(n, h, w, cm, cout, sm_count(), g);
  return th <= h && tw >= 1 && tw <= w &&
         (cs == 1 || cs == 2 || cs == 4 || cs == 8) &&
         channels_split(cm, cout, cs) && fitting(th, tw, cs, cm, cout, g);
}

// The weights' tensor maps, encoded once per (pointer, shape, box) and
// kept: the served forward hands the same weights to every call, and an
// encode is host time on a path that is already host-bound at batch 1.
struct WeightMaps {
  const void* w1;
  const void* w3;
  int cin, cm, cout, nrow1, nrow2;
  CUtensorMap m1, m3;
};

bool weight_maps(const void* w1, const void* w3, int cin, int cm, int cout,
                 int nrow1, int nrow2, CUtensorMap* m1, CUtensorMap* m3) {
  static std::mutex mu;
  static WeightMaps cache[64];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const WeightMaps& e = cache[i];
    if (e.w1 == w1 && e.w3 == w3 && e.cin == cin && e.cm == cm &&
        e.cout == cout && e.nrow1 == nrow1 && e.nrow2 == nrow2) {
      *m1 = e.m1;
      *m3 = e.m3;
      return true;
    }
  }
  WeightMaps e{w1, w3, cin, cm, cout, nrow1, nrow2, {}, {}};
  const uint64_t d1[2] = {(uint64_t)cin, (uint64_t)cm};
  const uint64_t s1[1] = {(uint64_t)cin * 2};
  const uint32_t b1[2] = {kKC, (uint32_t)nrow1};
  const uint64_t d3[3] = {(uint64_t)cm, 9, (uint64_t)cout};
  const uint64_t s3[2] = {(uint64_t)cm * 2, (uint64_t)cm * 18};
  const uint32_t b3[3] = {kKC, 1, (uint32_t)nrow2};
  if (!hopper::encode_bf16(&e.m1, w1, 2, d1, s1, b1) ||
      !hopper::encode_bf16(&e.m3, w3, 3, d3, s3, b3))
    return false;
  cache[next] = e;
  next = (next + 1) % 64;
  if (used < 64) ++used;
  *m1 = e.m1;
  *m3 = e.m3;
  return true;
}

}  // namespace

// The launch plan for a shape (th = 0) or the geometry of a given tile:
// out = {TH, TW, CS, shared-memory bytes, ring stages, tiles a phase-1
// pass covers, tiles a phase-2 pass covers, clusters of CS blocks the card
// runs at once}.
extern "C" int mcn_conv_pair_plan(int n, int h, int w, int cin, int cm,
                                  int cout, int th, int tw, int cs,
                                  int* out) {
  Geometry g;
  if (!geometry(n, h, w, cin, cm, cout, th, tw, cs, &g))
    return (int)cudaErrorInvalidValue;
  out[0] = g.th;
  out[1] = g.tw;
  out[2] = g.cs;
  out[3] = g.smem;
  out[4] = g.stages;
  out[5] = g.mt1 * g.nb1;
  out[6] = g.mt2 * g.nb2;
  out[7] = active_clusters(g.cs);
  return 0;
}

extern "C" int mcn_conv_pair(const void* x, const void* w1, const void* s1,
                             const void* b1, const void* w3, const void* s3,
                             const void* b3, void* y, int n, int h, int w,
                             int cin, int cm, int cout, int th, int tw,
                             int cs, void* stream) {
  Args a;
  if (!geometry(n, h, w, cin, cm, cout, th, tw, cs, &a.g))
    return (int)cudaErrorInvalidValue;
  const hopper::DeviceOf dev(x);
  if (dev.error() != cudaSuccess) return (int)dev.error();
  const Geometry& g = a.g;
  CUtensorMap mx, m1, m3;
  const uint64_t dx[4] = {(uint64_t)cin, (uint64_t)w, (uint64_t)h,
                          (uint64_t)n};
  const uint64_t sx[3] = {(uint64_t)cin * 2, (uint64_t)w * cin * 2,
                          (uint64_t)h * w * cin * 2};
  const uint32_t bx[4] = {kKC, (uint32_t)g.hw, (uint32_t)(g.th + 2), 1};
  if (!hopper::encode_bf16(&mx, x, 4, dx, sx, bx) ||
      !weight_maps(w1, w3, cin, cm, cout, g.nrow1, g.nrow2, &m1, &m3))
    return (int)cudaErrorInvalidValue;
  const cudaError_t opted = opt_in();
  if (opted != cudaSuccess) return (int)opted;
  a.s1 = static_cast<const float*>(s1);
  a.b1 = static_cast<const float*>(b1);
  a.s3 = static_cast<const float*>(s3);
  a.b3 = static_cast<const float*>(b3);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.h = h; a.w = w; a.cin = cin; a.cout = cout;
  a.tiles_x = (w + g.tw - 1) / g.tw;
  a.tiles_y = (h + g.th - 1) / g.th;
  const long long blocks = (long long)n * a.tiles_x * a.tiles_y * g.cs;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)g.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, conv_pair_kernel, mx, m1, m3, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
