// Exact multi-head attention in flash form: forward, dQ and dK/dV.
//
// Replaces the Pallas TPU kernels of myconvnet_tpu/ops/pallas/
// flash_attention.py: _fwd_kernel (pallas_call in _fwd), _dq_kernel and
// _dkv_kernel (the two pallas_calls in _bwd), tied together there by a
// custom_vjp and here by a torch.autograd.Function
// (ops/kernels/flash_attention.py).
//
//   forward:  S = scale Q K^T, P = softmax(S), O = P V,
//             lse = logsumexp(S) (float32, per query row)
//   dQ:       D = rowsum(dO * O), P = exp(S - lse), dP = dO V^T,
//             dS = P * (dP - D), dQ = scale dS K
//   dK/dV:    dV = P^T dO, dK = scale dS^T Q
//
// q, k, v, o, dO and the gradients are bf16 [B, H, L, D] tensors given by
// a base pointer and element strides (batch, head, row; the head dim is
// contiguous), so the kernels read q, k and v as strided views of the
// packed [B, L, 3, H, D] qkv projection and write O and the gradients in
// [B, L, H, D] without a transpose.  lse and D are float32 [B*H, Lpad]
// with Lpad = L rounded up to 64; the forward writes lse for every padded
// row (finite: a zero query row) and the dQ kernel writes D for them, so
// the dK/dV kernel loads whole 64-row tiles of both.
//
// The Pallas kernel keeps all of K and V of one (batch, head) in VMEM and
// takes the whole [block_q, L] score tile in one shot.  A Hopper block has
// at most 227 KB of shared memory and the blocks run in parallel, so here
// each 64-row tile loops over 64-row tiles of the other side, with an
// online softmax (running max and sum in float32 per row) in the forward.
// Keys past L in the last tile (197 = 3 * 64 + 5) are -inf before the max
// (P = 0 in the backward); rows past L are zero-filled and never stored.
//
// All three kernels share one shape, built for Hopper: every product is
// wgmma (bf16 in, float32 accumulate); every operand tile comes by TMA
// through tensor maps over the strided views (rows past L and columns past
// D zero-filled by the hardware) into 128-byte swizzled panels of 64
// columns; a producer keeps a ring of stages of the other side's tiles
// full, and one or two consumer warpgroups, each owning a 64-row tile,
// read every stage; results leave through a TMA store that drops rows past
// L.  The score tiles never leave the registers: each is re-packed in
// registers as the A operand of the next product, whose B operand (V, K,
// dO or Q along its rows) is read MN-major through the descriptor's
// transpose bit.
//
// * forward (flash_fwd_kernel): two query tiles a block, S = Q K^T, the
//   online softmax on the accumulators, O += P V;
// * dQ (flash_dq_kernel): two query tiles an item; each warpgroup's Q, dO
//   and O tiles come first, D = rowsum(dO * O) is summed from the dO and
//   O tiles in shared memory and written out; then per 128-key tile (64
//   at D > 64) S = Q K^T and dP = dO V^T as m64n128 products, dS = P *
//   (dP - D) in registers, dQ += dS K;
// * dK/dV (flash_dkv_kernel): two key tiles an item; per 64-query tile
//   S^T = K Q^T and dP^T = V dO^T with both operands K-major, P^T and dS^T
//   in registers with the query's lse and D read per column from 256-byte
//   rows that a bulk copy brings beside the Q and dO tiles, then dV +=
//   P^T dO and dK += dS^T Q.
// The backward kernels are persistent, with a producer warpgroup whose
// registers setmaxnreg hands to the consumers (design at bwd_warpgroups).
// Neither uses atomics: dQ is one pass over key tiles per query tile and
// dK/dV one pass over query tiles per key tile, each sum in a fixed order,
// so two runs are bit-equal; each recomputes S and dP.
//
// What bounds it on the H100: at ViT-B/16's [B, 12, 197, 64] bf16, the
// forward moves 8 B*H*L*D bytes (q, k, v, o) and does 4 B*H*L^2*D
// operations: 31 operations a byte, under the card's ~295, so it is bound
// by memory (at B = 256: 310 MB, 93 us at 3.35 TB/s; 30.5 GFLOP, 31 us at
// 989 TFLOP/s).  The forward reads K and V of a head twice at L = 197 (two
// blocks of two query tiles), once from HBM and once, mostly, from L2; its
// tensor-core work is small, so what it is up against is latency: two
// blocks a streaming multiprocessor, each with two warpgroups, overlap one
// warpgroup's softmax with another's products, and the block scheduler
// starts a new block as soon as one ends.  (A persistent grid that fetched
// the next item's tiles during this one, and issuing the next key tile's
// S behind P V, both ran slower on the H100; see PERF.md.)  Each backward
// kernel reads 6 and writes 1-2 tensors of B*H*L*D bf16 (dQ: q, k, v, o,
// dO, dq; dK/dV: q, k, v, dO, dk, dv) plus the float32 rows, 470 MB or
// 140 us at B = 256, against 6 (dQ) and 8 (dK/dV) B*H*L^2*D operations,
// 46 and 61 us: bound by memory too.  Here too the serial chain of a tile
// (two products, the exponentials, a third and fourth product) sets the
// pace, with two consumer warpgroups an SM (their accumulators take the
// registers).  Tried on the H100 and dropped, each slower: issuing the
// next tile's scores before this tile's exponentials (two sets of score
// registers; ptxas serialized the wgmmas), 128-query tiles in dK/dV, and
// K and V as register A operands of dK/dV's score products.  What is left
// is one fused backward that computes S and dP once (dQ summed across key
// tiles by a TMA reduce-add) and FA3's ping-pong of two warpgroups.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;  // rows of a tile (queries or keys)
constexpr float kLog2e = 1.4426950408889634f;

// strides (elements) of one [B, H, L, D] operand
struct View {
  long long sb, sh, sl;
};

enum { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV, kViews };

struct Args {
  const bf16 *q, *k, *v, *o, *dout;
  bf16 *out, *dq, *dk, *dv;
  float *lse, *dl;
  View view[kViews];
  int heads, len, lpad;
  float scale;
};

// ---------------------------------------------------------------- forward
//
// One block per (batch, head) and pair of 64-row query tiles: two consumer
// warpgroups, one per query tile, and one producer warp.  The producer
// brings each warpgroup's Q tile and then every 64-row K and V tile of the
// head by TMA into a ring of stages; both warpgroups read each K/V stage,
// which is released when both have arrived on its "empty" barrier.  Per
// key tile a warpgroup runs S = Q K^T as wgmma with both operands in
// shared memory (K-major SW128 tiles), the online softmax on the
// accumulator registers, and O += P V as wgmma with P re-packed in
// registers as the A operand and V read MN-major (the descriptor's
// transpose bit).  The output is rescaled, written swizzled into the
// warpgroup's (now free) Q tile and stored by one TMA store, which drops
// rows past L and columns past D.  Tiles are [64 rows x 64 bf16] panels
// (one panel for D <= 64, two for D <= 128); TMA zero-fills rows past L and
// columns past D, and the products run only over the real head dim.

constexpr int kFwdWarpgroups = 2;
constexpr int kFwdThreads = kFwdWarpgroups * 128 + 32;
constexpr int kPanel = 64 * 64 * 2;  // one SW128 [64 x 64] bf16 panel

// each map's tensor-map dimension (1..3) of the row, the head and the batch
enum { kMapQ, kMapK, kMapV, kMapO, kMaps };

struct FwdArgs {
  float* lse;
  int heads, len, lpad, groups;
  float scale;
  int pos[kMaps][3];
};

__device__ __forceinline__ void map_coords(int (&c)[4], const int* pos,
                                           int col, int row, int h, int b) {
  c[0] = col;
  c[pos[0]] = row;
  c[pos[1]] = h;
  c[pos[2]] = b;
}

template <int D>
__host__ __device__ constexpr int fwd_stages() {
  return D <= 64 ? 4 : 2;
}

template <int D>
__host__ __device__ constexpr int fwd_smem() {
  constexpr int tile = (D + 63) / 64 * kPanel;
  return 1024 + (kFwdWarpgroups + 2 * fwd_stages<D>()) * tile +
         8 * (kFwdWarpgroups + 2 * fwd_stages<D>());
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads, D <= 64 ? 2 : 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     const __grid_constant__ CUtensorMap mo,
                     const FwdArgs p) {
  using namespace hopper;
  constexpr int NP = (D + 63) / 64;
  constexpr int ST = fwd_stages<D>();
  constexpr int kTileBytes = NP * kPanel;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sk = sq + kFwdWarpgroups * kTileBytes;
  unsigned char* sv = sk + ST * kTileBytes;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sv + ST * kTileBytes);
  uint64_t* full = qbar + kFwdWarpgroups;
  uint64_t* empty = full + ST;

  const int wg = threadIdx.x / 128;
  const int bh = blockIdx.x / p.groups, grp = blockIdx.x % p.groups;
  const int b = bh / p.heads, h = bh % p.heads;
  const int ntiles = (p.len + kTile - 1) / kTile;
  const int qt0 = grp * kFwdWarpgroups;
  const int active = min(kFwdWarpgroups, ntiles - qt0);

  if (threadIdx.x == 0) {
    for (int w = 0; w < kFwdWarpgroups; ++w) mbar_init(&qbar[w], 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], active);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kFwdWarpgroups) {  // the producer warp
    if (threadIdx.x % 32 == 0) {
      int c[4];
      for (int w = 0; w < active; ++w) {
        mbar_expect_tx(&qbar[w], kTileBytes);
        for (int pn = 0; pn < NP; ++pn) {
          map_coords(c, p.pos[kMapQ], pn * 64, (qt0 + w) * kTile, h, b);
          tma_load_4d(sq + w * kTileBytes + pn * kPanel, &mq, &qbar[w], c[0],
                      c[1], c[2], c[3]);
        }
      }
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % ST;
        if (j >= ST) mbar_wait(&empty[s], (j / ST - 1) & 1);
        mbar_expect_tx(&full[s], 2 * kTileBytes);
        for (int pn = 0; pn < NP; ++pn) {
          map_coords(c, p.pos[kMapK], pn * 64, j * kTile, h, b);
          tma_load_4d(sk + s * kTileBytes + pn * kPanel, &mk, &full[s], c[0],
                      c[1], c[2], c[3]);
          map_coords(c, p.pos[kMapV], pn * 64, j * kTile, h, b);
          tma_load_4d(sv + s * kTileBytes + pn * kPanel, &mv, &full[s], c[0],
                      c[1], c[2], c[3]);
        }
      }
    }
    return;
  }
  if (wg >= active) return;  // past the last query tile

  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* myq = sq + wg * kTileBytes;
  const uint32_t q_addr = smem_addr(myq);
  const float sl2 = p.scale * kLog2e;

  float o[NP][32];
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[pn][e] = 0.f;
  // rows g and g + 8 of the warp: running max (log2 units) and sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(&qbar[wg], 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % ST;
    mbar_wait(&full[s], (j / ST) & 1);
    const uint32_t k_addr = smem_addr(sk + s * kTileBytes);
    const uint32_t v_addr = smem_addr(sv + s * kTileBytes);

    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = (ks / 4) * kPanel + (ks % 4) * 32;
      wgmma_ss(sc, desc_sw128(q_addr + off), desc_sw128(k_addr + off), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * kTile + n * 8 + 2 * t + (e & 1);
        const float x = col < p.len ? sc[4 * n + e] * sl2 : -INFINITY;
        sc[4 * n + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m[i] - mx[i]);  // 0 on the first tile
      m[i] = mx[i];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const float pv = exp2f(sc[e] - m[(e >> 1) & 1]);
      sc[e] = pv;
      rs[(e >> 1) & 1] += pv;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[pn][e] *= alpha[(e >> 1) & 1];

    // P as the A operand: keys 16 kk .. 16 kk + 15 are chunks 2 kk, 2 kk + 1
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[kk][r] = pack_bf16x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int pn = 0; pn < NP; ++pn)
        wgmma_rs_tb(o[pn], a[kk],
                    desc_sw128(v_addr + pn * kPanel + kk * 16 * 128));
    wgmma_commit();
    wgmma_wait<0>();
    if (tid == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const int row0 = (qt0 + wg) * kTile;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    if (t == 0)
      p.lse[(long long)bh * p.lpad + row0 + r] =
          (m[i] + log2f(l[i])) * (1.0f / kLog2e);
    const float inv = 1.0f / l[i];
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<uint32_t*>(myq + pn * kPanel + r * 128 +
                                     ((n ^ (r & 7)) * 16) + t * 4) =
            pack_bf16x2(o[pn][4 * n + 2 * i] * inv,
                        o[pn][4 * n + 2 * i + 1] * inv);
  }
  fence_proxy_async();
  named_barrier(1 + wg, 128);
  if (tid == 0) {
    int c[4];
    for (int pn = 0; pn < NP; ++pn) {
      map_coords(c, p.pos[kMapO], pn * 64, row0, h, b);
      tma_store_4d(&mo, myq + pn * kPanel, c[0], c[1], c[2], c[3]);
    }
    tma_store_commit_and_wait();
  }
}

// A tensor map over one strided [B, H, L, D] operand: the head dim first,
// then row, head and batch ordered by their strides; a box of 64 rows x 64
// columns.  pos gets the map dimension of the row, the head and the batch.
bool encode_view(CUtensorMap* map, const void* base, const View& v,
                 int batch, int heads, int len, int dim, int* pos) {
  long long stride[3] = {v.sl, v.sh, v.sb};
  const uint64_t extent[3] = {(uint64_t)len, (uint64_t)heads,
                              (uint64_t)batch};
  int order[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && stride[order[j]] < stride[order[j - 1]]; --j) {
      const int tmp = order[j];
      order[j] = order[j - 1];
      order[j - 1] = tmp;
    }
  uint64_t dims[4] = {(uint64_t)dim, 0, 0, 0}, strides[3];
  uint32_t box[4] = {64, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    const int which = order[i];
    dims[i + 1] = extent[which];
    strides[i] = (uint64_t)stride[which] * 2;
    if (which == 0) box[i + 1] = kTile;
    pos[which] = i + 1;
  }
  return hopper::encode_bf16(map, base, 4, dims, strides, box);
}

template <int D>
int launch_fwd(const Args& a, int batch, cudaStream_t stream) {
  CUtensorMap maps[kMaps];
  FwdArgs f;
  const void* bases[kMaps] = {a.q, a.k, a.v, a.out};
  const int views[kMaps] = {kQ, kK, kV, kO};
  for (int i = 0; i < kMaps; ++i)
    if (!encode_view(&maps[i], bases[i], a.view[views[i]], batch, a.heads,
                     a.len, D, f.pos[i]))
      return (int)cudaErrorInvalidValue;
  f.lse = a.lse;
  f.heads = a.heads;
  f.len = a.len;
  f.lpad = a.lpad;
  f.scale = a.scale;
  const int ntiles = (a.len + kTile - 1) / kTile;
  f.groups = (ntiles + kFwdWarpgroups - 1) / kFwdWarpgroups;
  const long long blocks = (long long)batch * a.heads * f.groups;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  constexpr int smem = fwd_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_kernel<D><<<(unsigned)blocks, kFwdThreads, smem, stream>>>(
      maps[kMapQ], maps[kMapK], maps[kMapV], maps[kMapO], f);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- backward
//
// Both backward kernels: a producer warp and W consumer warpgroups, each
// owning a 64-row tile of one side (queries in dQ, keys in dK/dV), whose
// tiles the producer brings first; then the producer streams every 64-row
// tile of the other side through a ring of ST stages, which every active
// warpgroup reads and releases on the stage's "empty" barrier.

constexpr int kBwdThreadsPerWg = 128;

struct BwdParams {
  CUtensorMap map[kViews];
  int pos[kViews][3];
  float* lse;
  float* dl;
  int heads, len, lpad, groups;
  int items;  // B * H * groups
  float scale;
};

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// the [R x 64 NP] tile of operand `view` at row `row` of head (b, h): NP
// panels of R rows, each brought as R / 64 boxes of 64 rows
template <int NP, int R = kTile>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const BwdParams& p, int view,
                                          uint64_t* bar, int row, int h,
                                          int b) {
  int c[4];
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int r = 0; r < R; r += kTile) {
      map_coords(c, p.pos[view], pn * 64, row + r, h, b);
      hopper::tma_load_4d(dst + pn * R * 128 + r * 128, &p.map[view], bar,
                          c[0], c[1], c[2], c[3]);
    }
}

template <int NP>
__device__ __forceinline__ void store_tile(const BwdParams& p, int view,
                                           unsigned char* src, int row,
                                           int h, int b) {
  int c[4];
#pragma unroll
  for (int pn = 0; pn < NP; ++pn) {
    map_coords(c, p.pos[view], pn * 64, row, h, b);
    hopper::tma_store_4d(&p.map[view], src + pn * kPanel, c[0], c[1], c[2],
                         c[3]);
  }
}

// acc * mul rounded to bf16 into a swizzled [64 x 64 NP] tile (the m64n64
// accumulator layout of hopper.cuh, one accumulator a panel)
template <int NP>
__device__ __forceinline__ void stage_acc(unsigned char* tile,
                                          const float (&acc)[NP][32],
                                          float mul, int warp, int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<uint32_t*>(tile + pn * kPanel + r * 128 +
                                     ((n ^ (r & 7)) * 16) + t * 4) =
            hopper::pack_bf16x2(acc[pn][4 * n + 2 * i] * mul,
                                acc[pn][4 * n + 2 * i + 1] * mul);
  }
}

// acc = A B^T over the head dim: A a [64 x D] and B an [N x D] K-major
// tile (panels of 64 columns, 64 and N rows); the first k16 step
// overwrites acc
template <int D, int N>
__device__ __forceinline__ void scores(float (&acc)[N / 2], uint32_t a_addr,
                                       uint32_t b_addr) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t col = (ks % 4) * 32;
    hopper::wgmma_ss(acc, hopper::desc_sw128(a_addr + (ks / 4) * kPanel + col),
                     hopper::desc_sw128(b_addr + (ks / 4) * N * 128 + col),
                     ks > 0);
  }
}

// the A operand (64 rows x 16 KK columns as KK k16 slices) from an m64
// accumulator of 16 KK columns, rounded to bf16
template <int KK>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[KK][4],
                                         const float (&acc)[KK * 8]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = hopper::pack_bf16x2(acc[8 * kk + 2 * r],
                                     acc[8 * kk + 2 * r + 1]);
}

// acc[pn] += A B with A from registers (64 rows x 16 KK of K) and B a
// [16 KK x D] tile read MN-major (its rows are K; panels of 16 KK rows)
template <int NP, int KK>
__device__ __forceinline__ void acc_rows(float (&acc)[NP][32],
                                         const uint32_t (&a)[KK][4],
                                         uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
      hopper::wgmma_rs_tb(acc[pn], a[kk],
                          hopper::desc_sw128(b_addr + pn * KK * 2048 +
                                             kk * 16 * 128));
}

// Both backward kernels are persistent: a grid of as many blocks as the
// card holds at once walks the items (one head's group of W 64-row tiles)
// blockIdx.x, + gridDim.x, ...; each
// warpgroup's own tiles are double buffered ("own" barriers per buffer and
// warpgroup), so the producer brings the next item's own tiles and first
// ring stages while the consumers work on this one (with one block an
// SM, which is all the registers allow, a grid of a block per item left
// each block's TMA prologue and store epilogue bare).  A tile's last
// products (dQ, or dV and dK) run on the tensor cores behind the next
// tile's score products; a ring stage is released once both have read it.
// Every warpgroup takes part in every item, also where the item has fewer
// tiles than warpgroups (odd tile counts): its tile lies past L, so it is
// zero-filled, computed and not stored, and every barrier's count stays
// the same from item to item.  W is 2 at D <= 64 and 1 above, where a
// warpgroup's accumulators (dK and dV: 128 registers a thread at D = 128)
// leave registers for one; the registers allow one block an SM.
template <int D>
__host__ __device__ constexpr int bwd_warpgroups() {
  return D <= 64 ? 2 : 1;
}

// the producer is a whole warpgroup, so that setmaxnreg can move its
// registers to the consumers: with two consumer warpgroups the 12 warps
// would get 168 registers each, too few for a consumer to keep its last
// products in flight while it issues the next tile's (ptxas serialized
// the wgmmas of dK/dV at 168); the producer keeps 40, the consumers get
// 232.  With one consumer warpgroup every warp gets 255 as it is.
template <int D>
__host__ __device__ constexpr int bwd_threads() {
  return (bwd_warpgroups<D>() + 1) * kBwdThreadsPerWg;
}

template <int W>
__device__ __forceinline__ void producer_registers() {
  if constexpr (W == 2) hopper::setmaxnreg_dec<40>();
}

template <int W>
__device__ __forceinline__ void consumer_registers() {
  if constexpr (W == 2) hopper::setmaxnreg_inc<232>();
}

// the dQ kernel's own tiles are Q, dO and O; its ring K and V tiles of
// dq_keys rows: 128 at D <= 64 (one m64n128 product a k16 step, half the
// barrier and wait round trips of 64-row tiles; S, dP, dS as A and dQ
// take 192 of the 232 registers), 64 above, where S and dP of 128 keys
// would not fit beside dQ's 64
template <int D>
__host__ __device__ constexpr int dq_keys() {
  return D <= 64 ? 128 : 64;
}

template <int D>
__host__ __device__ constexpr int dq_stages() {
  return D <= 64 ? 3 : 2;
}

template <int D>
__host__ __device__ constexpr int dq_smem() {
  constexpr int tile = (D + 63) / 64 * kPanel;
  constexpr int W = bwd_warpgroups<D>(), ST = dq_stages<D>();
  return 1024 + 2 * 3 * W * tile + 2 * ST * tile * dq_keys<D>() / kTile +
         8 * (4 * W + 2 * ST);
}

template <int D>
__global__ void __launch_bounds__(bwd_threads<D>(), 1)
    flash_dq_kernel(const __grid_constant__ BwdParams p) {
  using namespace hopper;
  constexpr int NP = (D + 63) / 64;
  constexpr int W = bwd_warpgroups<D>();
  constexpr int ST = dq_stages<D>();
  constexpr int KR = dq_keys<D>();
  constexpr int T = NP * kPanel;         // a 64-row tile
  constexpr int TK = NP * KR * 128;      // a KR-row tile of K or V
  extern __shared__ unsigned char smem_raw[];
  // buffer u of warpgroup w: Q at own + (u W + w) 3T, then dO, then O
  unsigned char* own = align_1024(smem_raw);
  unsigned char* sk = own + 2 * 3 * W * T;
  unsigned char* sv = sk + ST * TK;
  uint64_t* ofull = reinterpret_cast<uint64_t*>(sv + ST * TK);
  uint64_t* oempty = ofull + 2 * W;
  uint64_t* full = oempty + 2 * W;
  uint64_t* empty = full + ST;

  const int wg = threadIdx.x / kBwdThreadsPerWg;
  const int ntiles = (p.len + kTile - 1) / kTile;  // query tiles
  const int nkeys = (p.len + KR - 1) / KR;          // key tiles

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * W; ++i) {
      mbar_init(&ofull[i], 1);
      mbar_init(&oempty[i], 1);
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], W);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == W) {  // the producer warpgroup; one thread issues
    producer_registers<W>();
    if (threadIdx.x % kBwdThreadsPerWg == 0) {
      int jj = 0;  // ring steps so far
      int n = 0;   // this block's items so far
      for (int it = blockIdx.x; it < p.items; it += gridDim.x, ++n) {
        const int bh = it / p.groups, qt0 = it % p.groups * W;
        const int b = bh / p.heads, h = bh % p.heads;
        const int u = n & 1;
        for (int w = 0; w < W; ++w) {
          uint64_t* bar = &ofull[u * W + w];
          if (n >= 2) mbar_wait(&oempty[u * W + w], ((n >> 1) - 1) & 1);
          mbar_expect_tx(bar, 3 * T);
          unsigned char* t = own + (u * W + w) * 3 * T;
          const int row = (qt0 + w) * kTile;
          load_tile<NP>(t, p, kQ, bar, row, h, b);
          load_tile<NP>(t + T, p, kDO, bar, row, h, b);
          load_tile<NP>(t + 2 * T, p, kO, bar, row, h, b);
        }
        for (int j = 0; j < nkeys; ++j, ++jj) {
          const int s = jj % ST;
          if (jj >= ST) mbar_wait(&empty[s], (jj / ST - 1) & 1);
          mbar_expect_tx(&full[s], 2 * TK);
          load_tile<NP, KR>(sk + s * TK, p, kK, &full[s], j * KR, h, b);
          load_tile<NP, KR>(sv + s * TK, p, kV, &full[s], j * KR, h, b);
        }
      }
    }
  } else {  // a consumer warpgroup
    consumer_registers<W>();
    const int tid = threadIdx.x % kBwdThreadsPerWg, warp = tid / 32;
    const int g = (tid % 32) >> 2, t = tid & 3;
    const float sl2 = p.scale * kLog2e;
    int jj = 0, n = 0;
    for (int it = blockIdx.x; it < p.items; it += gridDim.x, ++n) {
      const int bh = it / p.groups, qt0 = it % p.groups * W;
      const int b = bh / p.heads, h = bh % p.heads;
      const int u = n & 1;
      unsigned char* myq = own + (u * W + wg) * 3 * T;
      const unsigned char* mydo = myq + T;
      const unsigned char* myo = myq + 2 * T;
      const uint32_t q_addr = smem_addr(myq), do_addr = smem_addr(mydo);
      const int row0 = (qt0 + wg) * kTile;
      const bool real = qt0 + wg < ntiles;  // else past Lpad: no lse, no D
      const long long rows = (long long)bh * p.lpad + row0;
      float lse2[2], dli[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        lse2[i] = real ? p.lse[rows + warp * 16 + g + 8 * i] * kLog2e : 0.f;

      mbar_wait(&ofull[u * W + wg], (n >> 1) & 1);
      // D = rowsum(dO * O) in float32 for rows g and g + 8 of the warp: each
      // thread of a quad sums 16-byte chunks 2t and 2t + 1 of every panel,
      // then the quad adds its four sums; written for every row up to Lpad
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = warp * 16 + g + 8 * i;
        float acc = 0.f;
#pragma unroll
        for (int pn = 0; pn < NP; ++pn)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int off =
                pn * kPanel + r * 128 + (((2 * t + cc) ^ (r & 7)) * 16);
            const uint4 ov = *reinterpret_cast<const uint4*>(myo + off);
            const uint4 dv = *reinterpret_cast<const uint4*>(mydo + off);
            const __nv_bfloat162* o2 =
                reinterpret_cast<const __nv_bfloat162*>(&ov);
            const __nv_bfloat162* d2 =
                reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 of = __bfloat1622float2(o2[e]);
              const float2 df = __bfloat1622float2(d2[e]);
              acc += of.x * df.x + of.y * df.y;
            }
          }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        dli[i] = acc;
        if (t == 0 && real) p.dl[rows + r] = acc;
      }

      float dq[NP][32];
#pragma unroll
      for (int pn = 0; pn < NP; ++pn)
#pragma unroll
        for (int e = 0; e < 32; ++e) dq[pn][e] = 0.f;

      // Per key tile S and dP are two wgmma groups, so that P = exp(S -
      // lse) is formed while dP is still on the tensor cores; the previous
      // tile's dQ += dS K runs behind both, and its stage is released once
      // that product is done.
      int pending = -1;
      for (int j = 0; j < nkeys; ++j, ++jj) {
        const int s = jj % ST;
        mbar_wait(&full[s], (jj / ST) & 1);
        const uint32_t k_addr = smem_addr(sk + s * TK);
        float sc[KR / 2], dp[KR / 2];
        wgmma_fence();
        scores<D, KR>(sc, q_addr, k_addr);
        wgmma_commit();
        scores<D, KR>(dp, do_addr, smem_addr(sv + s * TK));
        wgmma_commit();
        wgmma_wait<1>();
        if (pending >= 0 && tid == 0) mbar_arrive(&empty[pending]);
#pragma unroll
        for (int nn = 0; nn < KR / 8; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = j * KR + nn * 8 + 2 * t + (e & 1);
            sc[4 * nn + e] =
                col < p.len ? exp2f(sc[4 * nn + e] * sl2 - lse2[e >> 1])
                            : 0.f;  // P
          }
        wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < KR / 2; ++e)
          sc[e] *= dp[e] - dli[(e >> 1) & 1];  // dS
        uint32_t a[KR / 16][4];
        acc_to_a(a, sc);
        wgmma_fence();
        acc_rows<NP>(dq, a, k_addr);
        wgmma_commit();
        pending = s;
      }
      wgmma_wait<0>();
      if (tid == 0) mbar_arrive(&empty[pending]);

      // dQ through the warpgroup's Q tile, which no product reads any more;
      // the buffer goes back to the producer once the store has read it
      stage_acc<NP>(myq, dq, p.scale, warp, g, t);
      fence_proxy_async();
      named_barrier(1 + wg, kBwdThreadsPerWg);
      if (tid == 0) {
        store_tile<NP>(p, kDQ, myq, row0, h, b);
        tma_store_commit_and_wait();
        mbar_arrive(&oempty[u * W + wg]);
      }
    }
  }
}

// the dK/dV kernel's own tiles are K and V; its ring Q, dO and the
// queries' lse and D rows (256 bytes each, by a bulk copy).  Query tiles
// stay 64 rows: at 128 (as dQ's keys) S^T, dP^T, P^T and dS^T as A, dK and
// dV took more registers than a consumer has, ptxas serialized the wgmmas
// and the kernel ran 16% slower on the H100 (0.399 against 0.343 ms at
// [256, 12, 197, 64]).
template <int D>
__host__ __device__ constexpr int dkv_stages() {
  return D <= 64 ? 4 : 3;
}

constexpr int kRowBytes = 2 * kTile * 4;  // a stage's lse and D rows

template <int D>
__host__ __device__ constexpr int dkv_smem() {
  constexpr int tile = (D + 63) / 64 * kPanel;
  constexpr int W = bwd_warpgroups<D>(), ST = dkv_stages<D>();
  return 1024 + (2 * 2 * W + 2 * ST) * tile + ST * kRowBytes +
         8 * (4 * W + 2 * ST);
}

template <int D>
__global__ void __launch_bounds__(bwd_threads<D>(), 1)
    flash_dkv_kernel(const __grid_constant__ BwdParams p) {
  using namespace hopper;
  constexpr int NP = (D + 63) / 64;
  constexpr int W = bwd_warpgroups<D>();
  constexpr int ST = dkv_stages<D>();
  constexpr int T = NP * kPanel;
  extern __shared__ unsigned char smem_raw[];
  // buffer u of warpgroup w: K at own + (u W + w) 2T, V behind it
  unsigned char* own = align_1024(smem_raw);
  unsigned char* sq = own + 2 * 2 * W * T;
  unsigned char* sdo = sq + ST * T;
  float* srows = reinterpret_cast<float*>(sdo + ST * T);  // lse | D
  uint64_t* ofull = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(srows) + ST * kRowBytes);
  uint64_t* oempty = ofull + 2 * W;
  uint64_t* full = oempty + 2 * W;
  uint64_t* empty = full + ST;

  const int wg = threadIdx.x / kBwdThreadsPerWg;
  const int ntiles = (p.len + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * W; ++i) {
      mbar_init(&ofull[i], 1);
      mbar_init(&oempty[i], 1);
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], W);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == W) {  // the producer warpgroup; one thread issues
    producer_registers<W>();
    if (threadIdx.x % kBwdThreadsPerWg == 0) {
      int jj = 0;  // ring steps so far
      int n = 0;   // this block's items so far
      for (int it = blockIdx.x; it < p.items; it += gridDim.x, ++n) {
        const int bh = it / p.groups, kt0 = it % p.groups * W;
        const int b = bh / p.heads, h = bh % p.heads;
        const long long rows = (long long)bh * p.lpad;
        const int u = n & 1;
        for (int w = 0; w < W; ++w) {
          uint64_t* bar = &ofull[u * W + w];
          if (n >= 2) mbar_wait(&oempty[u * W + w], ((n >> 1) - 1) & 1);
          mbar_expect_tx(bar, 2 * T);
          unsigned char* kv = own + (u * W + w) * 2 * T;
          load_tile<NP>(kv, p, kK, bar, (kt0 + w) * kTile, h, b);
          load_tile<NP>(kv + T, p, kV, bar, (kt0 + w) * kTile, h, b);
        }
        for (int j = 0; j < ntiles; ++j, ++jj) {
          const int s = jj % ST;
          if (jj >= ST) mbar_wait(&empty[s], (jj / ST - 1) & 1);
          mbar_expect_tx(&full[s], 2 * T + kRowBytes);
          load_tile<NP>(sq + s * T, p, kQ, &full[s], j * kTile, h, b);
          load_tile<NP>(sdo + s * T, p, kDO, &full[s], j * kTile, h, b);
          float* r = srows + s * 2 * kTile;
          bulk_load(r, p.lse + rows + j * kTile, kTile * 4, &full[s]);
          bulk_load(r + kTile, p.dl + rows + j * kTile, kTile * 4, &full[s]);
        }
      }
    }
  } else {  // a consumer warpgroup
    consumer_registers<W>();
    const int tid = threadIdx.x % kBwdThreadsPerWg, warp = tid / 32;
    const int g = (tid % 32) >> 2, t = tid & 3;
    const float sl2 = p.scale * kLog2e;
    int jj = 0, n = 0;
    for (int it = blockIdx.x; it < p.items; it += gridDim.x, ++n) {
      const int bh = it / p.groups, kt0 = it % p.groups * W;
      const int b = bh / p.heads, h = bh % p.heads;
      const int u = n & 1;
      unsigned char* myk = own + (u * W + wg) * 2 * T;
      unsigned char* myv = myk + T;
      const uint32_t k_addr = smem_addr(myk), v_addr = smem_addr(myv);

      float dk[NP][32], dv[NP][32];
#pragma unroll
      for (int pn = 0; pn < NP; ++pn)
#pragma unroll
        for (int e = 0; e < 32; ++e) dk[pn][e] = dv[pn][e] = 0.f;

      mbar_wait(&ofull[u * W + wg], (n >> 1) & 1);
      // Per query tile S^T and dP^T are one wgmma group (two, as in dQ,
      // ran slower here); the previous tile's dV += P^T dO and dK += dS^T Q
      // run behind it, and its stage is released once they are done.
      int pending = -1;
      for (int j = 0; j < ntiles; ++j, ++jj) {
        const int s = jj % ST;
        mbar_wait(&full[s], (jj / ST) & 1);
        const uint32_t q_addr = smem_addr(sq + s * T);
        const uint32_t do_addr = smem_addr(sdo + s * T);
        const float* lt = srows + s * 2 * kTile;
        const float* dt = lt + kTile;
        // S^T and dP^T: 64 keys x 64 queries
        float sc[32], dp[32];
        wgmma_fence();
        scores<D, 64>(sc, k_addr, q_addr);
        scores<D, 64>(dp, v_addr, do_addr);
        wgmma_commit();
        wgmma_wait<0>();
        if (pending >= 0 && tid == 0) mbar_arrive(&empty[pending]);
#pragma unroll
        for (int nn = 0; nn < 8; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = nn * 8 + 2 * t + (e & 1);
            const float pv =
                j * kTile + c < p.len
                    ? exp2f(sc[4 * nn + e] * sl2 - lt[c] * kLog2e)
                    : 0.f;
            sc[4 * nn + e] = pv;                             // P^T
            dp[4 * nn + e] = pv * (dp[4 * nn + e] - dt[c]);  // dS^T
          }
        uint32_t a[4][4], ds[4][4];
        acc_to_a(a, sc);
        acc_to_a(ds, dp);
        wgmma_fence();
        acc_rows<NP>(dv, a, do_addr);
        acc_rows<NP>(dk, ds, q_addr);
        wgmma_commit();
        pending = s;
      }
      wgmma_wait<0>();
      if (tid == 0) mbar_arrive(&empty[pending]);

      // dK and dV through the warpgroup's K and V tiles; the buffer goes
      // back to the producer once the stores have read it
      stage_acc<NP>(myk, dk, p.scale, warp, g, t);
      stage_acc<NP>(myv, dv, 1.0f, warp, g, t);
      fence_proxy_async();
      named_barrier(1 + wg, kBwdThreadsPerWg);
      if (tid == 0) {
        const int row = (kt0 + wg) * kTile;
        store_tile<NP>(p, kDK, myk, row, h, b);
        store_tile<NP>(p, kDV, myv, row, h, b);
        tma_store_commit_and_wait();
        mbar_arrive(&oempty[u * W + wg]);
      }
    }
  }
}

// The blocks of a persistent grid: as many as the card holds at once,
// asked once per kernel
int resident_blocks(const void* kernel, int threads, int smem) {
  static std::mutex mu;
  static const void* kernels[32];
  static int known[32];
  static int used = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (kernels[i] == kernel) return known[i];
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess)
    return 0;
  if (used < 32) {
    kernels[used] = kernel;
    known[used++] = sms * per_sm;
  }
  return sms * per_sm;
}

enum Kind { kFwd, kDq, kDkv };

template <int D>
int launch_bwd(Kind kind, const Args& a, int batch, cudaStream_t stream) {
  static const int dq_views[] = {kQ, kK, kV, kO, kDO, kDQ};
  static const int dkv_views[] = {kQ, kK, kV, kDO, kDK, kDV};
  const int* views = kind == kDq ? dq_views : dkv_views;
  const void* bases[kViews] = {a.q, a.k, a.v, a.o, a.dout, a.dq, a.dk, a.dv};
  BwdParams p = {};
  for (int i = 0; i < 6; ++i) {
    const int v = views[i];
    if (!encode_view(&p.map[v], bases[v], a.view[v], batch, a.heads, a.len,
                     D, p.pos[v]))
      return (int)cudaErrorInvalidValue;
  }
  p.lse = a.lse;
  p.dl = a.dl;
  p.heads = a.heads;
  p.len = a.len;
  p.lpad = a.lpad;
  p.scale = a.scale;
  const int ntiles = (a.len + kTile - 1) / kTile;
  p.groups = (ntiles + bwd_warpgroups<D>() - 1) / bwd_warpgroups<D>();
  const long long items = (long long)batch * a.heads * p.groups;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.items = (int)items;
  void (*kernel)(const BwdParams) =
      kind == kDq ? flash_dq_kernel<D> : flash_dkv_kernel<D>;
  const int smem = kind == kDq ? dq_smem<D>() : dkv_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int resident =
      resident_blocks((const void*)kernel, bwd_threads<D>(), smem);
  if (resident == 0) return (int)cudaErrorInvalidValue;
  const long long grid = items < resident ? items : resident;
  kernel<<<(unsigned)grid, bwd_threads<D>(), smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch(Kind kind, const Args& a, int batch, cudaStream_t stream) {
  if (kind == kFwd) return launch_fwd<D>(a, batch, stream);
  return launch_bwd<D>(kind, a, batch, stream);
}

int dispatch(Kind kind, Args& a, const long long* strides, int batch,
             int heads, int len, int dim, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || len <= 0 || dim % 16 != 0 || dim <= 0 ||
      dim > 128 || (long long)batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  const hopper::DeviceOf dev(a.q);
  if (dev.error() != cudaSuccess) return (int)dev.error();
  for (int i = 0; i < kViews; ++i)
    a.view[i] = View{strides[3 * i], strides[3 * i + 1],
                     strides[3 * i + 2]};
  a.heads = heads;
  a.len = len;
  a.lpad = (len + kTile - 1) / kTile * kTile;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 16: return launch<16>(kind, a, batch, s);
    case 32: return launch<32>(kind, a, batch, s);
    case 48: return launch<48>(kind, a, batch, s);
    case 64: return launch<64>(kind, a, batch, s);
    case 80: return launch<80>(kind, a, batch, s);
    case 96: return launch<96>(kind, a, batch, s);
    case 112: return launch<112>(kind, a, batch, s);
    case 128: return launch<128>(kind, a, batch, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides: 8 x (batch, head, row) element strides of q, k, v, o, dO, dq,
// dk, dv (unused entries ignored); lse and dl are [B * H, Lpad] float32
extern "C" int mcn_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, const long long* strides,
                             int batch, int heads, int len, int dim,
                             float scale, void* stream) {
  Args a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.out = static_cast<bf16*>(out);
  a.lse = static_cast<float*>(lse);
  return dispatch(kFwd, a, strides, batch, heads, len, dim, scale, stream);
}

extern "C" int mcn_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const void* lse, void* dl, void* dq,
                                const long long* strides, int batch,
                                int heads, int len, int dim, float scale,
                                void* stream) {
  Args a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.dl = static_cast<float*>(dl);
  a.dq = static_cast<bf16*>(dq);
  return dispatch(kDq, a, strides, batch, heads, len, dim, scale, stream);
}

extern "C" int mcn_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* dl, void* dk, void* dv,
                                 const long long* strides, int batch,
                                 int heads, int len, int dim, float scale,
                                 void* stream) {
  Args a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.dl = const_cast<float*>(static_cast<const float*>(dl));
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  return dispatch(kDkv, a, strides, batch, heads, len, dim, scale, stream);
}
