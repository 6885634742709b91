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
// each query tile loops over 64-row tiles of the other side with an online
// softmax (running max and sum in float32 per row) in the forward.  Keys
// past L in the last tile (197 = 3 * 64 + 5) are -inf before the max (P = 0
// in the backward); query rows past L are zero-filled and never stored.
//
// The forward (design at flash_fwd_kernel) is built for Hopper: wgmma for
// both products, q, k and v brought by TMA through tensor maps over the
// strided views (rows past L zero-filled by the hardware), a producer warp
// that keeps a ring of K/V stages full, and K and V of a head read once for
// two query tiles.  The backward keeps its first design: one block per
// 64-row tile, four warps of 16 rows, mma.sync m16n8k16 from fragments
// loaded out of shared memory, cp.async into two buffers; the score
// accumulators are re-packed in registers as the A operand of the next
// product (dS K, P^T dO, dS^T Q), so no score leaves the SM.  It needs no
// atomics: dQ is one pass over key tiles per query tile, dK/dV one pass
// over query tiles per key tile, so both are deterministic; each recomputes
// S and dP.
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
// S behind P V, both ran slower on the H100; see PERF.md.)  The backward
// reads q, k, v, o, dO and writes dq, dk, dv (620 MB, 185 us) for
// 14 B*H*L^2*D operations (107 GFLOP, 108 us): bound by memory too; what it
// leaves on the table is the same Hopper path and one fused backward.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr int kTile = 64;      // rows of a tile (queries or keys)
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

__device__ __forceinline__ long long base_offset(const View& v, int b,
                                                 int h) {
  return (long long)b * v.sb + (long long)h * v.sh;
}

// cp.async a [64, D] tile (rows r0.. of a strided operand) into shared
// memory with row stride D + 8; rows at or past len are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base,
                                          long long sl, int r0, int len) {
  constexpr int kVec = D / 8;
  constexpr int kLd = D + 8;
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    const bf16* src = base;  // any valid address for a zero fill
    int fill = 16;
    if (r0 + r < len) {
      src = base + (long long)(r0 + r) * sl + c;
      fill = 0;
    }
    __pipeline_memcpy_async(dst + r * kLd + c, src, 16, fill);
  }
}

// cp.async 64 floats (a tile's lse or D) into shared memory
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int lane0) {
  const int i = threadIdx.x - lane0;
  if (i >= 0 && i < kTile / 4) __pipeline_memcpy_async(dst + 4 * i,
                                                       src + 4 * i, 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a * b for one m16n8k16 tile, bf16 in, float32 accumulate
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 rows x 16 columns from column c0) of a row-major tile
// whose first row is s; g = lane / 4, t = lane % 4
template <int LD>
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* s, int c0,
                                       int g, int t) {
  a[0] = ld32(s + g * LD + c0 + 2 * t);
  a[1] = ld32(s + (g + 8) * LD + c0 + 2 * t);
  a[2] = ld32(s + g * LD + c0 + 8 + 2 * t);
  a[3] = ld32(s + (g + 8) * LD + c0 + 8 + 2 * t);
}

// B fragment with B[k][n] = M[n0 + n][c0 + k] (M row-major: K in Q K^T)
template <int LD>
__device__ __forceinline__ void load_b_nk(uint32_t& b0, uint32_t& b1,
                                          const bf16* m, int n0, int c0,
                                          int g, int t) {
  const bf16* row = m + (n0 + g) * LD + c0 + 2 * t;
  b0 = ld32(row);
  b1 = ld32(row + 8);
}

// B fragment with B[k][n] = M[k0 + k][n0 + n] (M row-major: V in P V)
template <int LD>
__device__ __forceinline__ void load_b_kn(uint32_t& b0, uint32_t& b1,
                                          const bf16* m, int k0, int n0,
                                          int g, int t) {
  const bf16* col = m + (k0 + 2 * t) * LD + n0 + g;
  b0 = pack_bf16(col[0], col[LD]);
  b1 = pack_bf16(col[8 * LD], col[9 * LD]);
}

// the A fragment of keys (or queries) 16 kk .. 16 kk + 15 from a 16 x 64
// accumulator tile acc[8][4], rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float (*acc)[4],
                                         int kk) {
  a[0] = pack_f32(acc[2 * kk][0], acc[2 * kk][1]);
  a[1] = pack_f32(acc[2 * kk][2], acc[2 * kk][3]);
  a[2] = pack_f32(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
  a[3] = pack_f32(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
}

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

template <int D>
constexpr int dq_smem() {
  return 6 * kTile * (D + 8) * 2 + 2 * kTile * 4;  // Q, dO, 2 K, 2 V
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const Args p) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;
  constexpr int NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + kTile * LD;
  bf16* sk = sdo + kTile * LD;
  bf16* sv = sk + 2 * kTile * LD;
  float* slse = reinterpret_cast<float*>(sv + 2 * kTile * LD);
  float* sdl = slse + kTile;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int q0 = blockIdx.x * kTile;
  const int len = p.len;
  const View &vq = p.view[kQ], &vk = p.view[kK], &vv = p.view[kV],
             &vo = p.view[kO], &vdo = p.view[kDO];
  const bf16* qb = p.q + base_offset(vq, b, h);
  const bf16* kb = p.k + base_offset(vk, b, h);
  const bf16* vb = p.v + base_offset(vv, b, h);
  const bf16* dob = p.dout + base_offset(vdo, b, h);
  const int ntiles = (len + kTile - 1) / kTile;
  const float sl2 = p.scale * kLog2e;
  const long long row0 = (long long)bh * p.lpad + q0;

  load_tile<D>(sq, qb, vq.sl, q0, len);
  load_tile<D>(sdo, dob, vdo.sl, q0, len);
  load_tile<D>(sk, kb, vk.sl, 0, len);
  load_tile<D>(sv, vb, vv.sl, 0, len);
  load_rows_f32(slse, p.lse + row0, 0);
  __pipeline_commit();

  // D = rowsum(dO * O) in float32: two threads a row, D / 2 columns each
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int row = q0 + r;
    float acc = 0.f;
    if (row < len) {
      const bf16* orow = p.o + base_offset(vo, b, h) +
                         (long long)row * vo.sl + half * (D / 2);
      const bf16* drow = dob + (long long)row * vdo.sl + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
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
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      sdl[r] = acc;
      p.dl[row0 + r] = acc;
    }
  }

  float dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  uint32_t qa[KS][4], da[KS][4];
  float lse2[2], dli[2];

  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      const int nb = (j + 1) & 1;
      load_tile<D>(sk + nb * kTile * LD, kb, vk.sl, (j + 1) * kTile, len);
      load_tile<D>(sv + nb * kTile * LD, vb, vv.sl, (j + 1) * kTile, len);
      __pipeline_commit();
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        load_a<LD>(qa[ks], sq + warp * 16 * LD, ks * 16, g, t);
        load_a<LD>(da[ks], sdo + warp * 16 * LD, ks * 16, g, t);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        lse2[i] = slse[warp * 16 + g + 8 * i] * kLog2e;
        dli[i] = sdl[warp * 16 + g + 8 * i];
      }
    }
    const bf16* kt = sk + (j & 1) * kTile * LD;
    const bf16* vt = sv + (j & 1) * kTile * LD;

    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b0, b1;
        load_b_nk<LD>(b0, b1, kt, n * 8, ks * 16, g, t);
        mma(s[n], qa[ks], b0, b1);
        load_b_nk<LD>(b0, b1, vt, n * 8, ks * 16, g, t);
        mma(dp[n], da[ks], b0, b1);
      }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * kTile + n * 8 + 2 * t + (e & 1);
        const float pv =
            col < len ? exp2f(s[n][e] * sl2 - lse2[e >> 1]) : 0.f;
        s[n][e] = pv * (dp[n][e] - dli[e >> 1]);  // dS
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s, kk);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        load_b_kn<LD>(b0, b1, kt, kk * 16, n * 8, g, t);
        mma(dq[n], a, b0, b1);
      }
    }
    __syncthreads();
  }

  const View& vdq = p.view[kDQ];
  bf16* dqb = p.dq + base_offset(vdq, b, h);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    if (row < len) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<uint32_t*>(dqb + (long long)row * vdq.sl + n * 8 +
                                     2 * t) =
            pack_f32(dq[n][2 * i] * p.scale, dq[n][2 * i + 1] * p.scale);
    }
  }
}

template <int D>
constexpr int dkv_smem() {
  // K, V, two Q and two dO tiles; two lse and two D rows
  return 6 * kTile * (D + 8) * 2 + 4 * kTile * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const Args p) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;
  constexpr int NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + kTile * LD;
  bf16* sq = sv + kTile * LD;
  bf16* sdo = sq + 2 * kTile * LD;
  float* slse = reinterpret_cast<float*>(sdo + 2 * kTile * LD);
  float* sdl = slse + 2 * kTile;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int k0 = blockIdx.x * kTile;
  const int len = p.len;
  const View &vq = p.view[kQ], &vk = p.view[kK], &vv = p.view[kV],
             &vdo = p.view[kDO];
  const bf16* qb = p.q + base_offset(vq, b, h);
  const bf16* dob = p.dout + base_offset(vdo, b, h);
  const int ntiles = (len + kTile - 1) / kTile;
  const float sl2 = p.scale * kLog2e;
  const float* lse = p.lse + (long long)bh * p.lpad;
  const float* dl = p.dl + (long long)bh * p.lpad;

  load_tile<D>(sk, p.k + base_offset(vk, b, h), vk.sl, k0, len);
  load_tile<D>(sv, p.v + base_offset(vv, b, h), vv.sl, k0, len);
  load_tile<D>(sq, qb, vq.sl, 0, len);
  load_tile<D>(sdo, dob, vdo.sl, 0, len);
  load_rows_f32(slse, lse, 0);
  load_rows_f32(sdl, dl, 32);
  __pipeline_commit();

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  uint32_t ka[KS][4], va[KS][4];

  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      const int nb = (j + 1) & 1, r0 = (j + 1) * kTile;
      load_tile<D>(sq + nb * kTile * LD, qb, vq.sl, r0, len);
      load_tile<D>(sdo + nb * kTile * LD, dob, vdo.sl, r0, len);
      load_rows_f32(slse + nb * kTile, lse + r0, 0);
      load_rows_f32(sdl + nb * kTile, dl + r0, 32);
      __pipeline_commit();
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        load_a<LD>(ka[ks], sk + warp * 16 * LD, ks * 16, g, t);
        load_a<LD>(va[ks], sv + warp * 16 * LD, ks * 16, g, t);
      }
    }
    const int buf = j & 1;
    const bf16* qt = sq + buf * kTile * LD;
    const bf16* dot = sdo + buf * kTile * LD;
    const float* lt = slse + buf * kTile;
    const float* dt = sdl + buf * kTile;

    // S^T and dP^T: 16 keys of this warp x 64 queries
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b0, b1;
        load_b_nk<LD>(b0, b1, qt, n * 8, ks * 16, g, t);
        mma(s[n], ka[ks], b0, b1);
        load_b_nk<LD>(b0, b1, dot, n * 8, ks * 16, g, t);
        mma(dp[n], va[ks], b0, b1);
      }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        const float pv = j * kTile + c < len
                             ? exp2f(s[n][e] * sl2 - lt[c] * kLog2e)
                             : 0.f;
        s[n][e] = pv;                      // P^T
        dp[n][e] = pv * (dp[n][e] - dt[c]);  // dS^T
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4], ds[4];
      acc_to_a(a, s, kk);
      acc_to_a(ds, dp, kk);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        load_b_kn<LD>(b0, b1, dot, kk * 16, n * 8, g, t);
        mma(dv[n], a, b0, b1);
        load_b_kn<LD>(b0, b1, qt, kk * 16, n * 8, g, t);
        mma(dk[n], ds, b0, b1);
      }
    }
    __syncthreads();
  }

  const View &vdk = p.view[kDK], &vdv = p.view[kDV];
  bf16* dkb = p.dk + base_offset(vdk, b, h);
  bf16* dvb = p.dv + base_offset(vdv, b, h);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + warp * 16 + g + 8 * i;
    if (row < len) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int c = n * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(dkb + (long long)row * vdk.sl + c) =
            pack_f32(dk[n][2 * i] * p.scale, dk[n][2 * i + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dvb + (long long)row * vdv.sl + c) =
            pack_f32(dv[n][2 * i], dv[n][2 * i + 1]);
      }
    }
  }
}

enum Kind { kFwd, kDq, kDkv };

template <int D>
int launch(Kind kind, const Args& a, int batch, cudaStream_t stream) {
  if (kind == kFwd) return launch_fwd<D>(a, batch, stream);
  const dim3 grid((unsigned)((a.len + kTile - 1) / kTile),
                  (unsigned)(batch * a.heads), 1);
  void (*kernel)(const Args) =
      kind == kDq ? flash_dq_kernel<D> : flash_dkv_kernel<D>;
  const int smem = kind == kDq ? dq_smem<D>() : dkv_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch(Kind kind, Args& a, const long long* strides, int batch,
             int heads, int len, int dim, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || len <= 0 || dim % 16 != 0 || dim <= 0 ||
      dim > 128 || (long long)batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
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
