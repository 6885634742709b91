// Hopper (sm_90a) building blocks shared by the kernels that run on the
// tensor cores through wgmma and are fed by TMA: mbarriers, tensor-map
// loads and stores, plain bulk copies, 4-, 8- and 16-byte cp.async copies
// (completing on an mbarrier or in groups), cluster barriers and reads of
// another block's shared memory, shared-memory matrix descriptors, the
// wgmma shapes the kernels use (m64n16k16, m64n40k16, m64n64k16, m64n72k16
// and m64n128k16, bf16 in, float32 accumulate; m64n32k16 and m64n64k16
// also with A from registers and B MN-major), register moves between
// warpgroups (setmaxnreg), division by a divisor fixed at launch
// (FastDiv) and a host-side tensor-map encoder reached through the
// runtime's driver entry point (so the library needs no -lcuda).
//
// Conventions:
// * every SW128 tile is a [rows][64 bf16] block of 128-byte rows whose base
//   is 1024-byte aligned, written by TMA with CU_TENSOR_MAP_SWIZZLE_128B:
//   the 16-byte chunk c of row r sits at chunk c ^ (r % 8);
// * a K-major SW128 descriptor steps through K by adding 32 bytes (16
//   bf16) to its start address inside the 128-byte row; 8-row groups are
//   1024 bytes apart (SBO);
// * the no-swizzle ("interleave") K-major layout is a grid of core
//   matrices of 8 rows x 16 bytes, each 128 contiguous bytes; LBO is the
//   distance between core matrices along K, SBO along M or N.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the async proxy (TMA) and
// to the other blocks of a cluster
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// nanoseconds of the card's global timer (wall-clock time)
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// A wait longer than this is a lost arrival, never a slow pipeline: the
// kernels' waits last microseconds.
constexpr uint64_t kMaxWaitNs = 10ull * 1000 * 1000 * 1000;

// wait until the phase with the given parity has completed; a wait that
// lasts kMaxWaitNs (10 s of wall-clock time) traps instead of hanging the
// card, so the launch fails with an error
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  if (mbar_try_wait(addr, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(addr, parity))
    if (global_ns() - t0 > kMaxWaitNs) __trap();
}

// ------------------------------------------------------------------ TMA

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes global -> shared (both 16-byte aligned, bytes a
// multiple of 16), completion counted on the barrier like a tensor load
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// 4 bytes global -> shared without registers; src_bytes 0 writes zeros
// (src must still be a valid address)
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(src_bytes)
               : "memory");
}

// 8 bytes global -> shared (both 8-byte aligned); src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async_8(void* dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(src_bytes)
               : "memory");
}

// 16 bytes global -> shared (both 16-byte aligned), bypassing L1
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}

// the barrier's current phase cannot complete before this thread's
// earlier cp.async copies have landed (the pending count goes up now and
// down when they complete)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// closes this thread's group of cp.async copies issued since the last one
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared -> global; elements outside the tensor are not written
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit_and_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory become visible to the async proxy
// (wgmma operands, TMA stores)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier among `threads` threads (a multiple of 32) under id `id` (1-15)
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Hands this warpgroup's registers back (dec) or takes more (inc), to
// `regs` a thread; every warp of the warpgroup runs it.  The kernel must
// split into one branch per role that never rejoins, or ptxas ignores it.
template <int regs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(regs));
}
template <int regs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(regs));
}

// ------------------------------------------------------------- clusters

// A barrier over every thread of every block of the cluster: arrive
// releases this thread's writes (shared memory included), wait acquires
// the others'.  Every thread of the cluster has to arrive, so a warp that
// is done early arrives and waits all the same.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// 16 bytes of block `rank`'s shared memory at the offset of `p` in this
// block's (distributed shared memory; the other block must still be
// running, which a cluster barrier after the read guarantees)
__device__ __forceinline__ float4 ld_cluster_f4(const void* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// ------------------------------------------------------------ descriptors

__device__ __forceinline__ uint64_t desc_encode(uint32_t x) {
  return (uint64_t)((x & 0x3FFFF) >> 4);
}

// K-major (or, with the transpose bit, MN-major) SW128 tile; for an
// MN-major tile of exactly 64 columns only the 1024-byte stride between
// 8-row groups along K is used, so both offsets are set to it
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return desc_encode(addr) | (desc_encode(1024) << 16) |
         (desc_encode(1024) << 32) | (1ull << 62);
}

// the same with the 64-byte swizzle ([rows][32 bf16] tiles, 8-row groups
// 512 bytes apart, base 512-byte aligned; K-major steps through K by 32
// bytes, an MN-major tile is exactly 32 columns)
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return desc_encode(addr) | (desc_encode(512) << 16) |
         (desc_encode(512) << 32) | (2ull << 62);
}

// K-major, no swizzle: core matrices lbo bytes apart along K, sbo along M/N
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return desc_encode(addr) | (desc_encode(lbo) << 16) |
         (desc_encode(sbo) << 32);
}

// ------------------------------------------------------------------ wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The m64n64 float32 accumulator: thread t of the warpgroup holds, for
// each 8-column chunk j, d[4j], d[4j+1] at row 16 (t/32) + (t%32)/4,
// columns 8j + 2 (t%4) + {0, 1}, and d[4j+2], d[4j+3] eight rows below.
#define HOPPER_ACC32(d)                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define HOPPER_D32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d (+)= A B, A [64 x 16] and B [16 x 64] both from shared memory, both
// K-major; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// The m64n16 and m64n40 float32 accumulators: as m64n64 with 2 and 5
// chunks of 8 columns.
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[20], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19}, %20, %21, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The m64n72 float32 accumulator: as m64n64 with 9 chunks of 8 columns.
#define HOPPER_ACC36(d)                                                      \
  HOPPER_ACC32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
#define HOPPER_D36                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35}"

// d (+)= A B, A [64 x 16] and B [16 x 72] both from shared memory, both
// K-major (B's 72 rows are nine 8-row groups 1024 bytes apart); scale_d =
// 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[36], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 " HOPPER_D36
      ", %36, %37, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_ACC36(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// The m64n128 float32 accumulator: as m64n64 with 16 chunks of 8 columns.
#define HOPPER_ACC64(d) \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
    "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
    "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
    "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
    "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
    "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), \
    "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), \
    "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), \
    "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
    "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
    "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define HOPPER_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63}"

// d (+)= A B, A [64 x 16] and B [16 x 128] both from shared memory, both
// K-major (B's 128 rows continue its 8-row groups 1024 bytes apart);
// scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_ACC64(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B with A [64 x 16] from registers (the mma.sync A-fragment layout
// per warp: a0 rows g / cols 2t, a1 rows g+8, a2 cols 8+2t, a3 both) and B
// from shared memory MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// as above, with scale_d = 0 overwriting d (no generic write of the
// accumulators is needed to start a sum)
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t* a,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (+)= A B as above with N = 32 (B one 32-column MN-major tile): the
// m64n32 accumulator, 4 chunks of 8 columns
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[16], const uint32_t* a,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------- tensor maps

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// For its lifetime, makes the device that holds `p` current on this
// thread, and with it the device's primary context, which the tensor-map
// encoder needs: a thread that has made no CUDA call yet (autograd's
// worker thread, say) has none.  The caller's current device comes back
// when the guard goes out of scope, so a launch on a tensor of another
// card leaves the thread's device as it was.
class DeviceOf {
 public:
  explicit DeviceOf(const void* p) {
    cudaPointerAttributes attr;
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess) err_ = cudaPointerGetAttributes(&attr, p);
    if (err_ == cudaSuccess) err_ = cudaSetDevice(attr.device);
    restore_ = err_ == cudaSuccess && attr.device != prev_;
  }
  ~DeviceOf() {
    if (restore_) cudaSetDevice(prev_);
  }
  DeviceOf(const DeviceOf&) = delete;
  DeviceOf& operator=(const DeviceOf&) = delete;
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool restore_ = false;
  cudaError_t err_;
};

// A tensor map of `rank` dimensions (innermost first): dims, byte strides
// of dims 1.., box; zero fill outside the tensor.  False if the driver
// refuses it.
inline bool encode_tiled(CUtensorMap* map, CUtensorMapDataType type,
                         CUtensorMapSwizzle swizzle, const void* base,
                         int rank, const uint64_t* dims,
                         const uint64_t* strides, const uint32_t* box) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  return fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), d, s, b,
            e, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Division by a divisor fixed at launch, set up on the host: n / d as a
// high multiply and a shift (exact for 0 <= n < 2^31, 1 <= d < 2^31), so a
// kernel's index set-up costs no integer division.
struct FastDiv {
  int d;
  uint32_t mul, shr;
  FastDiv() = default;
  explicit FastDiv(int divisor) : d(divisor), mul(0), shr(0) {
    if (d > 1) {
      uint32_t log2 = 0;
      while ((1u << log2) < (uint32_t)d) ++log2;
      const uint32_t p = 31 + log2;
      mul = (uint32_t)(((1ull << p) + (uint32_t)d - 1) / (uint32_t)d);
      shr = p - 32;
    }
  }
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : (int)(__umulhi((uint32_t)n, mul) >> shr);
  }
  __device__ __forceinline__ int mod(int n) const { return n - div(n) * d; }
};

// A bf16 tensor map with the 128-byte swizzle (the SW128 tiles above).
inline bool encode_bf16(CUtensorMap* map, const void* base, int rank,
                        const uint64_t* dims, const uint64_t* strides,
                        const uint32_t* box) {
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      CU_TENSOR_MAP_SWIZZLE_128B, base, rank, dims, strides,
                      box);
}

}  // namespace hopper
