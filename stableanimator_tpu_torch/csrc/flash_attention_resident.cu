// Resident-K/V flash-attention forward for Hopper (sm_90a), bf16 / fp16, d = 64.
//
// Replaces the TPU kernel stableanimator_tpu/ops/flash_attention.py::
// _fwd_kernel_resident (driven there by _flash_fwd_resident). It computes the
// streamed kernel's function (csrc/flash_attention_fwd.cu), with its rounding:
//     o = softmax((q * scale) k^T) v      and optionally  lse = m + log(l),
// q scaled in fp32 and rounded to the input type, the logits, running max m,
// normaliser l and accumulator in fp32, P rounded to the input type before
// P.V while l sums the unrounded P, and the kv tail masked with -inf; 128-key
// tiles and exp as exp2, so tests/test_torch_flash_attention.py's case
// (1024, 5, 64, bf16, 128, exp2) of
// test_kernel_tolerance_accepts_the_kernels_rounding_and_rejects_faults
// emulates its rounding.
//
// What makes it its own kernel is the TPU kernel's defining property: the K
// and V of one (batch, head) are fetched once and reused by many q tiles
// (there they sit in VMEM while the q tiles stream past). Here every K/V tile
// is fetched from L2 once per thread-block cluster and multicast by TMA into
// the shared memory of each of its CLUSTER = 2 CTAs, which take consecutive
// 192-row q tiles of the same (batch, head). Clusters of 4 were timed against
// it and ran slower at both UNet shapes (PERF.md section 6).
//
// What bounds it: the streamed kernel's work, 4*B*H*Sq*Sk*d operations on a
// few MB of inputs, so the tensor cores (256 operations per logit at 989
// TFLOP/s) and the MUFU unit (one exponential per logit, 16 per clock per
// SM) about equally; and behind them the reads of K and V from L2, which the
// streamed kernel makes once per CTA (at UNet level 0, 3520 CTAs each read
// the head's 1 MiB of K and V: ~3.4 GiB per launch) and this one once per
// cluster, CLUSTER times fewer. The bytes each SM takes in stay the same.
//
// The design is the streamed kernel's CTA program, shared through
// csrc/flash_fwd_d64.cuh (d64::attend with CLUSTER > 1): a producer
// warpgroup whose one thread issues the TMA loads into a 4-stage ring, three
// consumer warpgroups of 64 q rows in ping-pong running wgmma m64n128k16 for
// Q K^T and m64n64k16 for P V with P in registers, the softmax in
// registers, O stored by TMA and lse from registers. What the cluster adds:
//  - tile j is loaded by the producer of cluster rank j % CLUSTER, multicast
//    to every CTA (cp.async.bulk.tensor ... .multicast::cluster); each CTA's
//    full barrier expects the whole tile's bytes, whoever issued it, and may
//    receive them before its own producer announces them;
//  - a stage is refilled only when the consumers of every CTA have released
//    it: each consumer warp arrives on that stage's empty barrier in every
//    CTA of the cluster (lane r on rank r's, through mapa), so each empty
//    barrier counts CLUSTER x 12 arrivals and every producer waits on its
//    own. The arrival releases at CTA scope only: the wgmma reads it hands
//    back have completed, and a release at cluster scope, a cluster-wide
//    fence per warp and tile, cost more than the whole multicast saved;
//  - the grid is rounded up to whole clusters, so a CTA may have no q rows:
//    it loads no Q and stores nothing, but its producer loads and announces
//    its tiles and its consumers wait for and release every tile, or the
//    cluster would deadlock;
//  - the mbarriers are initialised and fenced (fence.mbarrier_init.release.
//    cluster) before each thread's first arrival on the cluster barrier,
//    and each thread waits on it before its first multicast or remote
//    arrival; each arrives again once it has issued its last and waits
//    before it exits, so no CTA leaves while a peer may still write its
//    shared memory or arrive on its barriers. Split in halves, the barrier
//    overlaps the Q load at the start and the last P V and the epilogue at
//    the end. Every CTA walks the same ring in the same order, so the phase
//    parities agree across the cluster.
// Measured on the H100 (PERF.md section 6), the cluster does not pay: the
// streamed kernel is not held back by L2, each SM still takes in every K/V
// byte, and a cluster costs its barriers and the scheduling of CTAs in
// pairs, so this kernel runs about a tenth behind the streamed one.
//
// One CTA per SM (512 threads, ~153 KiB of shared memory), as the streamed
// kernel; a cluster of CLUSTER CTAs needs that many free SMs in one GPC
// (sa_flash_attention_resident_max_clusters reports how many fit at once).
//
// C interface (bound with ctypes): sa_flash_attention_resident returns the
// cudaError_t of the launch, 0 on success, and cudaErrorInvalidValue for a
// shape it does not take or a layout whose tensor map the CUDA driver
// refuses; a cluster launch the driver refuses returns its error.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_fwd_d64.cuh"
#include "sm90.cuh"

namespace {

// CTAs per cluster, each taking one 192-row q tile of the (batch, head) and
// sharing every K/V tile; clusters of 4 ran slower at both UNet shapes
// (PERF.md section 6)
constexpr int CLUSTER = 2;

template <typename T>
__global__ void __launch_bounds__(d64::NTHREADS, 1)
    flash_resident_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_o, const d64::Params p) {
  extern __shared__ unsigned char smem_raw[];
  d64::attend<T, CLUSTER>(smem_raw, &tm_q, &tm_k, &tm_v, &tm_o, p);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, Sq, H] fp32, or null
  int b, sq, sk, h;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
};

// the launch configuration of a grid of `ctas` x h x b CTAs in clusters of
// CLUSTER along x; `attr` holds the cluster dimension it points to
cudaLaunchConfig_t cluster_config(int ctas, int h, int b, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, h, b);
  cfg.blockDim = dim3(d64::NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = d64::SMEM;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
cudaError_t prepare() {
  return cudaFuncSetAttribute(flash_resident_sm90_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)d64::SMEM);
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using sm90::make_map;
  constexpr bool is_half = std::is_same<T, __half>::value;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!make_map(&tm_q, a.q, is_half, a.sq, a.h, a.b, a.q_sb, a.q_ss, a.q_sh, d64::BQ) ||
      !make_map(&tm_k, a.k, is_half, a.sk, a.h, a.b, a.k_sb, a.k_ss, a.k_sh, d64::BK) ||
      !make_map(&tm_v, a.v, is_half, a.sk, a.h, a.b, a.v_sb, a.v_ss, a.v_sh, d64::BK) ||
      !make_map(&tm_o, a.o, is_half, a.sq, a.h, a.b, a.o_sb, a.o_ss, a.o_sh, 64))
    return cudaErrorInvalidValue;
  d64::Params p{a.lse, a.sq, a.sk, a.h, a.scale};
  cudaError_t err = prepare<T>();
  if (err != cudaSuccess) return err;
  const int tiles = (a.sq + d64::BQ - 1) / d64::BQ;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config((tiles + CLUSTER - 1) / CLUSTER * CLUSTER, a.h, a.b, stream, &attr);
  void* args[] = {&tm_q, &tm_k, &tm_v, &tm_o, &p};
  err = cudaLaunchKernelExC(&cfg, (const void*)flash_resident_sm90_kernel<T>, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" int sa_flash_attention_resident(const void* q, const void* k, const void* v, void* o,
                                           void* lse, int dtype, int b, int sq, int sk, int h,
                                           int d, long long q_sb, long long q_ss, long long q_sh,
                                           long long k_sb, long long k_ss, long long k_sh,
                                           long long v_sb, long long v_ss, long long v_sh,
                                           long long o_sb, long long o_ss, long long o_sh,
                                           float scale, void* stream) {
  if (d != d64::D || sq <= 0 || sk <= 0 || h <= 0 || h > 65535 || b <= 0 || b > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q,    k,    v,    o,    static_cast<float*>(lse), b,    sq,   sk,  h,
               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<__nv_bfloat16>(a, s);
  if (dtype == 1) return (int)launch<__half>(a, s);
  return (int)cudaErrorInvalidValue;
}

// how many of the kernel's clusters the card runs at once
// (cudaOccupancyMaxActiveClusters), into *count
extern "C" int sa_flash_attention_resident_max_clusters(int* count) {
  cudaError_t err = prepare<__nv_bfloat16>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(CLUSTER, 1, 1, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(
      count, (const void*)flash_resident_sm90_kernel<__nv_bfloat16>, &cfg);
}
