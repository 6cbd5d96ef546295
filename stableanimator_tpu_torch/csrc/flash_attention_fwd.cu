// Streamed flash-attention forward for Hopper (sm_90a), bf16 / fp16.
//
// Replaces the TPU kernel stableanimator_tpu/ops/flash_attention.py::_fwd_kernel
// (driven there by _flash_fwd_bshd). Computes, per (batch, head),
//     o = softmax((q * scale) k^T) v      and optionally  lse = m + log(l),
// with the TPU kernel's rounding: q is scaled in fp32 and rounded to the
// input type, the logits, running max m, normaliser l and accumulator stay
// fp32, P = exp(s - m) is rounded to the input type before P.V while l sums
// the unrounded P, and the kv tail is masked with -inf. Inputs are read in
// the model's [B, S, H, D] layout through their strides (last dim
// contiguous), so no transposes surround the call. Two kernels, chosen by
// the head dim:
//
// d = 64, the UNet's attentions (flash_fwd_sm90_kernel, whose CTA program,
// csrc/flash_fwd_d64.cuh, the resident kernel shares). At the main path's
// shapes (4096 / 1024 tokens) the work is 4*B*H*Sq*Sk*d operations on a few
// MB of inputs, far above the card's ~295 operations per byte: the bytes are
// no limit. Two units are, about equally: the tensor cores (256 operations
// per logit at 989 TFLOP/s) and the MUFU unit, which takes one exponential
// per logit at 16 per clock per SM (at UNet level 0, 2.7 G exponentials are
// ~0.64 ms on 132 SMs at 1.98 GHz against ~0.70 ms of tensor-core time).
// The design:
//  - one CTA per (192-row q tile, head, batch), four warpgroups: a producer,
//    whose one thread issues the TMA loads and whose registers setmaxnreg
//    hands to the others, and three consumers of 64 q rows each;
//  - TMA loads through 4-D tensor maps (D, S, H, B) built on the host over
//    the strided tensors, 128-byte swizzled: Q once, then 128-key K and V
//    tiles into a ring of 4 stages with full / empty mbarriers, so the
//    producer keeps the next tiles in flight while the consumers work. TMA
//    fills rows past the end with zeros, which give logits of 0, so the kv
//    tail is still masked;
//  - S = Q K^T by wgmma m64n128k16 from shared memory (each consumer first
//    scales and rounds its Q rows in place); the online softmax on the
//    accumulator fragment in registers, exp(x) as exp2(x * log2 e) with
//    log2 e folded into one FFMA, quad shuffles for the row max, l kept per
//    thread and summed across the quad at the end; P packed to 16 bits in
//    registers is the A operand of O += P V, wgmma m64n64k16 with V read
//    MN-major. No logits or P pass through shared memory and no block-wide
//    barrier runs inside the kv loop;
//  - the exponentials overlap the products twice over: a consumer issues
//    tile j's Q K^T and tile j-1's P V before it waits for the first, so
//    tile j's softmax runs while the tensor cores do that P V; and the
//    consumers take turns (ping-pong on named barriers) to issue their
//    products, so one's softmax runs under the others' products (three
//    consumers with ping-pong beat two without at every UNet shape on the
//    H100; PERF.md section 6);
//  - epilogue: O / l, rounded, is staged in the swizzled layout into the
//    warpgroup's own Q rows (no longer read) and written by one TMA store,
//    which drops the rows past the q tail; lse goes straight from registers.
//
// d = 512, the VAE decoder's mid attention (flash_fwd_d512_sm90_kernel, CTA
// program in csrc/flash_fwd_d512.cuh). Two bounds. The tensor cores: at the
// VAE's [16, 4096, 1, 512] the work is 4*B*H*Sq*Sk*d = 550 G operations.
// And the bytes out of L2: a 64 x 512 fp32 accumulator is half the SM's
// registers, so a CTA takes 64 q rows only, and each reads its head's whole
// K and V, 8 MB at 4096 keys, for 64 rows' work: 17 GB per launch, about 64
// bytes per clock per SM at the tensor cores' rate. Each SM must take in
// those bytes, and its shared memory must pass them beside the products'
// operands. The design:
//  - one CTA per (64-row q tile, head, batch), each reading its K and V from
//    L2. Clusters of 2 and 4 CTAs along the q tiles of one head, each K/V
//    tile read once and multicast by TMA into every CTA, divided the L2
//    bytes but were timed slower on the H100 (the CTAs wait for each other
//    at every stage; PERF.md section 6): the L2 bytes are not what holds
//    this kernel back, so it runs no cluster;
//  - a producer warpgroup (one thread issues the TMA loads; setmaxnreg 24)
//    and two consumer warpgroups (240) that split d: consumer c owns
//    O[:, 256c .. 256c + 255] (128 fp32 registers a thread);
//  - TMA through the same 4-D tensor maps as d = 64, a [rows, 512] tile as
//    8 boxes of one 128-byte-swizzled 64-column block, into one mbarrier
//    transaction: Q once (64 KB), 32-key K and V tiles (32 KB each) through a
//    ring of 2 stages, K and V with barriers of their own, so a consumer can
//    hand back K while it still reads V (225 KB of shared memory in all);
//  - S = Q K^T with the reduction split between the consumers: each issues
//    its half (wgmma m64n32k16 from shared memory), the two swap their fp32
//    partials through shared memory and both add them, S = S_0 + S_1 in the
//    same bits, so each reads only its half of every K and V tile and the
//    products issued are the function's own; the online softmax in
//    registers, exp as exp2; O_c += P V by wgmma m64n256k16 with P in
//    registers and V read MN-major;
//  - a consumer issues tile j's logits and tile j-1's P V before it waits, so
//    the exchange and the softmax run under the products;
//  - epilogue: O / l, rounded, staged swizzled into Q's blocks and written by
//    TMA stores (q tail dropped); lse from registers.
// At one CTA per SM (225 KB, 384 threads), the VAE's 1024 CTAs are 7.8
// waves on 132 SMs. PERF.md section 6 gives its times beside both bounds.
//
// C interface (bound with ctypes): sa_flash_attention_fwd returns the
// cudaError_t of the launch (cudaGetLastError), 0 on success,
// cudaErrorInvalidValue for a head dim it does not take (64 and 512 only) or
// a layout whose tensor map the CUDA driver refuses.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_fwd_d512.cuh"
#include "flash_fwd_d64.cuh"
#include "sm90.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, Sq, H] fp32, or null
  int sq, sk, h;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
};

// ---------------------------------------------------------------------------
// d = 64: wgmma, TMA, warp specialisation (csrc/flash_fwd_d64.cuh)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(d64::NTHREADS, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_o, const d64::Params p) {
  extern __shared__ unsigned char smem_raw[];
  d64::attend<T, 1>(smem_raw, &tm_q, &tm_k, &tm_v, &tm_o, p);
}

template <typename T>
cudaError_t launch_d64(const Params& a, int b, cudaStream_t stream) {
  using sm90::make_map;
  constexpr bool is_half = std::is_same<T, __half>::value;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!make_map(&tm_q, a.q, is_half, a.sq, a.h, b, a.q_sb, a.q_ss, a.q_sh, d64::BQ) ||
      !make_map(&tm_k, a.k, is_half, a.sk, a.h, b, a.k_sb, a.k_ss, a.k_sh, d64::BK) ||
      !make_map(&tm_v, a.v, is_half, a.sk, a.h, b, a.v_sb, a.v_ss, a.v_sh, d64::BK) ||
      !make_map(&tm_o, a.o, is_half, a.sq, a.h, b, a.o_sb, a.o_ss, a.o_sh, 64))
    return cudaErrorInvalidValue;
  const d64::Params p{a.lse, a.sq, a.sk, a.h, a.scale};
  auto kernel = flash_fwd_sm90_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)d64::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + d64::BQ - 1) / d64::BQ, a.h, b);
  kernel<<<grid, d64::NTHREADS, d64::SMEM, stream>>>(tm_q, tm_k, tm_v, tm_o, p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// d = 512: wgmma, TMA, d split between two consumers (csrc/flash_fwd_d512.cuh)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(d512::NTHREADS, 1)
    flash_fwd_d512_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_o, const d512::Params p) {
  extern __shared__ unsigned char smem_raw[];
  d512::attend<T>(smem_raw, &tm_q, &tm_k, &tm_v, &tm_o, p);
}

template <typename T>
cudaError_t launch_d512(const Params& a, int b, cudaStream_t stream) {
  using sm90::make_map;
  constexpr bool is_half = std::is_same<T, __half>::value;
  constexpr int D = d512::D;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!make_map(&tm_q, a.q, is_half, a.sq, a.h, b, a.q_sb, a.q_ss, a.q_sh, d512::BQ, D) ||
      !make_map(&tm_k, a.k, is_half, a.sk, a.h, b, a.k_sb, a.k_ss, a.k_sh, d512::BK, D) ||
      !make_map(&tm_v, a.v, is_half, a.sk, a.h, b, a.v_sb, a.v_ss, a.v_sh, d512::BK, D) ||
      !make_map(&tm_o, a.o, is_half, a.sq, a.h, b, a.o_sb, a.o_ss, a.o_sh, d512::BQ, D))
    return cudaErrorInvalidValue;
  const d512::Params p{a.lse, a.sq, a.sk, a.h, a.scale};
  auto kernel = flash_fwd_d512_sm90_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)d512::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + d512::BQ - 1) / d512::BQ, a.h, b);
  kernel<<<grid, d512::NTHREADS, d512::SMEM, stream>>>(tm_q, tm_k, tm_v, tm_o, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int b, int d, cudaStream_t stream) {
  if (d == 64) return launch_d64<T>(p, b, stream);
  if (d == 512) return launch_d512<T>(p, b, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int sa_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                      int dtype, int b, int sq, int sk, int h, int d,
                                      long long q_sb, long long q_ss, long long q_sh,
                                      long long k_sb, long long k_ss, long long k_sh,
                                      long long v_sb, long long v_ss, long long v_sh,
                                      long long o_sb, long long o_ss, long long o_sh,
                                      float scale, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.sq = sq;
  p.sk = sk;
  p.h = h;
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.o_sb = o_sb;
  p.o_ss = o_ss;
  p.o_sh = o_sh;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<__nv_bfloat16>(p, b, d, s);
  if (dtype == 1) return (int)dispatch<__half>(p, b, d, s);
  return (int)cudaErrorInvalidValue;
}
