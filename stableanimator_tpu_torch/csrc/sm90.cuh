// PTX wrappers for Hopper (sm_90a) shared by the port's CUDA sources, after
// the conversions between fp32 and the 16-bit input types: mbarriers (local,
// and arrivals on a peer CTA's), TMA tensor loads (local, and multicast into
// the CTAs of a cluster) and stores and 1-D bulk copies, the cluster's rank
// and barrier, warpgroup matrix multiply (wgmma) with its shared-memory
// descriptors, named barriers and setmaxnreg; the exponential, the
// forwards' online softmax on a wgmma accumulator fragment and the
// backwards' hi / lo split of one into register A fragments and its
// store through strides; and, on the
// host, the TMA tensor maps over [B, S, H, D] tensors in 64-column blocks.
//
// Operand layouts follow the PTX ISA: a tile that TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B (rows of 128 bytes, the 16-byte chunk c of row
// r stored at chunk c ^ (r % 8), the tile 1024-byte aligned) is a canonical
// 128-byte-swizzled wgmma operand. K-major (the reduction dim contiguous):
// 8-row groups 1024 bytes apart, and a k16 step of 16-bit values is 32 bytes
// further along the row. MN-major (the output dim contiguous, the
// "transposed" B): rows are the reduction dim, 8-row groups 1024 bytes apart
// (the stride byte offset), a k16 step is 2048 bytes further, and the next
// 64 columns along N lie the leading byte offset further.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// conversions between fp32 and the 16-bit input type T: one value each way,
// two fp32 values rounded and packed into one 32-bit register (lo in the low
// half), and such a register back to two fp32 values
template <typename T>
struct Cvt;

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) { return __float2bfloat16_rn(x); }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void unpack(uint32_t u, float& lo, float& hi) {
    lo = __uint_as_float(u << 16);
    hi = __uint_as_float(u & 0xffff0000u);
  }
};

template <>
struct Cvt<__half> {
  static __device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
  static __device__ __forceinline__ __half from_f(float x) { return __float2half_rn(x); }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void unpack(uint32_t u, float& lo, float& hi) {
    const float2 f = __half22float2(*reinterpret_cast<__half2*>(&u));
    lo = f.x;
    hi = f.y;
  }
};

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA transactions
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival on the barrier at `bar`'s offset in the shared memory of the
// cluster's CTA `cta` (this CTA's own included). Its release is at CTA scope,
// as CUTLASS's ClusterBarrier::arrive: to hand a stage back to a peer's
// producer, the reads it follows must have completed (wgmma.wait_group).
// A release at cluster scope makes every arrival a cluster-wide fence, which
// slowed the resident kernel markedly on the H100 (PERF.md section 6).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(smem_u32(bar)), "r"(cta)
      : "memory");
}

// waits for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ---------------------------------------------------------------------------
// thread-block clusters
// ---------------------------------------------------------------------------

// this CTA's rank in its cluster, 0 .. cluster size - 1
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  return rank;
}

// the two halves of a barrier over every thread of every CTA of the cluster
// (not .aligned: the threads of a warp need not arrive together). A thread
// arrives once, may work on, and waits before it arrives again; the wait
// returns when every thread of the cluster has arrived. The arrival releases
// and the wait acquires at cluster scope, so what a thread wrote to shared
// memory or initialised before its arrival is visible cluster-wide after
// the wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// box of a 4-D map at coordinates (c0, c1, c2, c3), innermost first, into
// shared memory; completes `bytes` announced on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// tma_load_4d into every CTA of the cluster whose rank is set in `cta_mask`:
// the box lands at `dst`'s offset in each one's shared memory and completes
// its bytes on the barrier at `bar`'s offset there
__device__ __forceinline__ void tma_load_4d_multicast(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, uint16_t cta_mask, int c0,
                                                      int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3, %4, %5}], [%6], %7;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar)), "h"(cta_mask)
      : "memory");
}

// `bytes` (a multiple of 16) of global memory at `src` into shared memory
// at `dst`, both 16-byte aligned; completes `bytes` announced on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// shared memory to a 4-D map's box; rows outside the tensor are not written
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// commits the thread's TMA stores and waits until their source is read
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// orders the thread's generic-proxy shared-memory writes before later
// async-proxy reads (wgmma operands, TMA stores)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// barriers among warps, register reallocation
// ---------------------------------------------------------------------------

__device__ __forceinline__ void named_bar_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int nthreads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// descriptor of a 128-byte-swizzled operand at `p`; `lbo` / `sbo` are the
// leading / stride byte offsets
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N committed wgmma groups of the thread are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across this point
template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define SA_SM90_ACC64(d)                                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),         \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),      \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),      \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),      \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),      \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),      \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define SA_SM90_ACC32(d)                                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),         \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),      \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

#define SA_SM90_REGS64                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "    \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "\
  "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "\
  "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

#define SA_SM90_REGS32                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "    \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

#define SA_SM90_ACC128(d)                                                                \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),         \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),      \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),      \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),      \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),      \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),      \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),      \
      "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),      \
      "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),      \
      "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),      \
      "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),      \
      "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),      \
      "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),                 \
      "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),              \
      "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),              \
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),              \
      "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),              \
      "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),              \
      "+f"(d[127])

#define SA_SM90_REGS128                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "    \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "     \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "     \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "     \
  "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "     \
  "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "     \
  "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "         \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "       \
  "%124, %125, %126, %127}"

#define SA_SM90_ACC16(d)                                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),         \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

#define SA_SM90_REGS16                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

#define SA_SM90_ACC8(d)                                                                  \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
      "+f"(d[7])

#define SA_SM90_REGS8 "{%0, %1, %2, %3, %4, %5, %6, %7}"

// d[64] (+)= A B for a 64 x 128 tile, k = 16: A (64 x 16) and B (128 rows of
// 16) both K-major in shared memory; scale_d = 0 overwrites d
template <typename T>
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " SA_SM90_REGS64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : SA_SM90_ACC64(d)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SA_SM90_REGS64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : SA_SM90_ACC64(d)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
}

// d[32] (+)= A B for a 64 x 64 tile, k = 16: A (64 x 16) and B (64 rows of
// 16) both K-major in shared memory; scale_d = 0 overwrites d
template <typename T>
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " SA_SM90_REGS32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : SA_SM90_ACC32(d)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SA_SM90_REGS32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : SA_SM90_ACC32(d)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
}

// d[16] (+)= A B for a 64 x 32 tile, k = 16: A (64 x 16) and B (32 rows of
// 16) both K-major in shared memory; scale_d = 0 overwrites d
template <typename T>
__device__ __forceinline__ void wgmma_ss_m64n32k16(float (&d)[16], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 " SA_SM90_REGS16
        ", %16, %17, p, 1, 1, 0, 0;\n}\n"
        : SA_SM90_ACC16(d)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " SA_SM90_REGS16
        ", %16, %17, p, 1, 1, 0, 0;\n}\n"
        : SA_SM90_ACC16(d)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
}

// d[8] (+)= A B for a 64 x 16 tile, k = 16: A (64 x 16) and B (16 rows of
// 16) both K-major in shared memory; scale_d = 0 overwrites d
template <typename T>
__device__ __forceinline__ void wgmma_ss_m64n16k16(float (&d)[8], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.f16.f16 " SA_SM90_REGS8
        ", %8, %9, p, 1, 1, 0, 0;\n}\n"
        : SA_SM90_ACC8(d)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " SA_SM90_REGS8
        ", %8, %9, p, 1, 1, 0, 0;\n}\n"
        : SA_SM90_ACC8(d)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
}

// d[128] += A B for a 64 x 256 tile, k = 16: A (64 x 16) from registers in
// the m16n8k16 fragment layout of each warp's 16 rows, B (16 rows of 256)
// MN-major in shared memory: four 64-wide swizzled groups along N, the
// descriptor's leading byte offset apart
template <typename T>
__device__ __forceinline__ void wgmma_rs_m64n256k16_tn(float (&d)[128], uint32_t a0, uint32_t a1,
                                                       uint32_t a2, uint32_t a3,
                                                       uint64_t desc_b) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 " SA_SM90_REGS128
        ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : SA_SM90_ACC128(d)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " SA_SM90_REGS128
        ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : SA_SM90_ACC128(d)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
  }
}

// d[64] += A B for a 64 x 128 tile, k = 16: A (64 x 16) from registers in
// the m16n8k16 fragment layout of each warp's 16 rows, B (16 rows of 128)
// MN-major in shared memory: two 64-wide swizzled groups along N, the
// descriptor's leading byte offset apart
template <typename T>
__device__ __forceinline__ void wgmma_rs_m64n128k16_tn(float (&d)[64], uint32_t a0, uint32_t a1,
                                                       uint32_t a2, uint32_t a3,
                                                       uint64_t desc_b) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " SA_SM90_REGS64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : SA_SM90_ACC64(d)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SA_SM90_REGS64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : SA_SM90_ACC64(d)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
  }
}

// d[32] += A B for a 64 x 64 tile, k = 16: A (64 x 16) from registers in the
// m16n8k16 fragment layout of each warp's 16 rows, B (16 rows of 64) MN-major
// in shared memory
template <typename T>
__device__ __forceinline__ void wgmma_rs_m64n64k16_tn(float (&d)[32], uint32_t a0, uint32_t a1,
                                                      uint32_t a2, uint32_t a3,
                                                      uint64_t desc_b) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " SA_SM90_REGS32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : SA_SM90_ACC32(d)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SA_SM90_REGS32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : SA_SM90_ACC32(d)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
  }
}

// ---------------------------------------------------------------------------
// the exponential, and the forwards' online softmax on a wgmma accumulator
// ---------------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one kv tile whose logits are in s, the accumulator
// fragment of an m64n(2N) wgmma: s[4n], s[4n+1] in row g, s[4n+2], s[4n+3] in
// row g + 8, columns 8n + 2t, 8n + 2t + 1. Masks the columns at or past
// `valid`, turns s into P = exp(s - m_new) in place (exp(x) as
// exp2(x log2 e), log2 e folded into one FFMA), updates the running max m
// and this thread's share of l (the unrounded P), and returns in a_lo / a_hi
// the factors that rescale the accumulator.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], int valid, int t, float& m_lo,
                                             float& m_hi, float& l_lo, float& l_hi, float& a_lo,
                                             float& a_hi) {
  if (valid < 2 * N) {
#pragma unroll
    for (int n = 0; n < N / 4; ++n) {
      const int c = 8 * n + 2 * t;
      if (c >= valid) s[4 * n] = s[4 * n + 2] = -INFINITY;
      if (c + 1 >= valid) s[4 * n + 1] = s[4 * n + 3] = -INFINITY;
    }
  }
  float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[4 * n], s[4 * n + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
  }
  // every tile holds a valid key, so mx is finite; exp2(-inf) = 0 at the first
  a_lo = ex2((m_lo - mx_lo) * LOG2E);
  a_hi = ex2((m_hi - mx_hi) * LOG2E);
  const float ms_lo = mx_lo * LOG2E, ms_hi = mx_hi * LOG2E;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    s[4 * n] = ex2(fmaf(s[4 * n], LOG2E, -ms_lo));
    s[4 * n + 1] = ex2(fmaf(s[4 * n + 1], LOG2E, -ms_lo));
    s[4 * n + 2] = ex2(fmaf(s[4 * n + 2], LOG2E, -ms_hi));
    s[4 * n + 3] = ex2(fmaf(s[4 * n + 3], LOG2E, -ms_hi));
    sum_lo += s[4 * n] + s[4 * n + 1];
    sum_hi += s[4 * n + 2] + s[4 * n + 3];
  }
  l_lo = l_lo * a_lo + sum_lo;
  l_hi = l_hi * a_hi + sum_hi;
  m_lo = mx_lo;
  m_hi = mx_hi;
}

// P (fp32, an m64n(2N) accumulator fragment) rounded to T as the A fragments
// of N / 8 k16 steps: the accumulator's layout is the A operand's
template <typename T, int N>
__device__ __forceinline__ void pack_p(const float (&s)[N], uint32_t (&pa)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    pa[4 * kk] = Cvt<T>::pack(s[8 * kk], s[8 * kk + 1]);
    pa[4 * kk + 1] = Cvt<T>::pack(s[8 * kk + 2], s[8 * kk + 3]);
    pa[4 * kk + 2] = Cvt<T>::pack(s[8 * kk + 4], s[8 * kk + 5]);
    pa[4 * kk + 3] = Cvt<T>::pack(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// x (fp32, an m64n(N / 4 * 8) accumulator fragment) as the A fragments of
// N / 8 k16 steps in two 16-bit parts, hi = round(x) and lo = round(x - hi),
// so that a product keeps about 16 bits of x: the accumulator's layout is
// the A operand's, pairs of neighbouring columns in one register
template <typename T, int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N / 2],
                                      uint32_t (&lo)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    float h0, h1;
    hi[i] = Cvt<T>::pack(x[2 * i], x[2 * i + 1]);
    Cvt<T>::unpack(hi[i], h0, h1);
    lo[i] = Cvt<T>::pack(x[2 * i] - h0, x[2 * i + 1] - h1);
  }
}

// rows `row` and `row` + 8 of an m64n(2 N) accumulator fragment (columns
// 8n + 2t, + 1) times `mul`, rounded to T, into a [S, cols] slice whose
// column 0 is at `base`, `row_stride` elements a row; rows at or past
// `valid` dropped
template <typename T, int N>
__device__ __forceinline__ void store_rows(T* base, long long row_stride, int valid, int row,
                                           int t, const float (&acc)[N], float mul) {
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    const int col = 8 * n + 2 * t;
    if (row < valid)
      *reinterpret_cast<uint32_t*>(base + (long long)row * row_stride + col) =
          Cvt<T>::pack(acc[4 * n] * mul, acc[4 * n + 1] * mul);
    if (row + 8 < valid)
      *reinterpret_cast<uint32_t*>(base + (long long)(row + 8) * row_stride + col) =
          Cvt<T>::pack(acc[4 * n + 2] * mul, acc[4 * n + 3] * mul);
  }
}

// ---------------------------------------------------------------------------
// TMA tensor maps (host)
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the CUDA driver's cuTensorMapEncodeTiled, found through the runtime, so a
// library needs no -lcuda
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-D tensor map (D, S, H, B) over a [B, S, H, D] 16-bit tensor with head
// dim d (a multiple of 64) and element strides (sb, ss, sh), boxes of
// `rows` x 64, 128-byte swizzled: a box is one 64-column block of `rows`
// rows, at column coordinate 64 i; rows past the end read as zeros and are
// not written.
inline bool make_map(CUtensorMap* map, const void* base, bool is_half, int s, int h, int b,
                     long long sb, long long ss, long long sh, int rows, int d = 64) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || d % 64 != 0) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)h, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, is_half ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                4, const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
