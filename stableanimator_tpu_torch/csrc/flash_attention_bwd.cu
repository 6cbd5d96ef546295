// Flash-attention backward for Hopper (sm_90a), bf16 / fp16, head dim 64.
//
// Replaces the TPU kernels stableanimator_tpu/ops/flash_attention.py::
// _bwd_dkv_kernel and ::_bwd_dq_kernel (driven there by _flash_bwd). From
// q, k, v, dO (the model's [B, S, H, D] layout, read through their strides)
// and the fp32 vectors lse and delta = sum(dO * o) the two kernels compute,
// in fp32,
//     S = scale q k^T, P = exp(S - lse), dP = dO v^T, dS = P (dP - delta),
//     dV = P^T dO, dK = scale dS^T q, dQ = scale dS k,
// and write dQ, dK, dV in the input type. lse and delta come as
// [B, H, Sq_pad] fp32, contiguous, with Sq_pad = Sq rounded up to 64 and
// the padding zero (the wrapper lays them out so: TMA needs 16-byte strides,
// and [B, Sq, H] rows are 4 H bytes apart).
//
//   flash_bwd_dkv_sm90_kernel: one CTA per (128 kv rows, head, batch). Its K
//     and V stay in shared memory and its fp32 dK, dV in registers while it
//     streams every 64-row q tile; q rows past the end get P = 0.
//   flash_bwd_dq_sm90_kernel: one CTA per (128 q rows, head, batch),
//     streaming every 64-row kv tile (the kv tail masked to P = 0); it
//     recomputes S and dP.
// Two kernels rather than one with atomics: each output element is summed by
// one CTA in a fixed order, so the result is the same from run to run. A loop
// inside each CTA takes the place of the TPU's sequential fori_loop over the
// other axis.
//
// What bounds it. P and dS are fp32 and enter the 16-bit tensor cores as two
// parts, hi = round(x) and lo = round(x - hi), so the products keep about 16
// bits of them (grad_tolerance in ops/flash_attention.py rests on it); that
// doubles the dV, dK and dQ products. dK/dV issues 6 products of
// 2 B H Sq Sk d operations (S^T, dP^T, dV hi and lo, dK hi and lo), dQ 4 (S,
// dP, dQ hi and lo): at the training shapes (4096 / 1024 tokens, d = 64) far
// above the card's ~295 operations per byte, so the tensor cores bound both,
// at 1.5x (dK/dV) and 1.33x (dQ) the function's own work. Beside them the
// FP32 pipe does about 10 operations per logit (subtracting lse, exp2,
// dP - delta, the product with P, and the hi / lo split of P and dS); that
// work must run under the products, not between them.
//
// The design, from the patterns of the d = 64 forward (flash_attention_fwd.cu):
//  - warp specialisation: a producer warpgroup, whose one thread issues every
//    load and whose registers setmaxnreg hands to the others (24 left), and
//    two consumer warpgroups of 64 rows each (240 registers: the dK/dV
//    consumer holds S^T and dP^T, 32 + 32, the dK and dV accumulators,
//    32 + 32, and the hi / lo A fragments of P^T and dS^T, 64);
//  - TMA loads through 4-D tensor maps (D, S, H, B) over the strided inputs,
//    128-byte swizzled (the canonical wgmma layout): the CTA's own rows
//    (K and V, or Q and dO) once, then the streamed tiles (Q, dO and 1-D bulk
//    copies of their lse and delta; or K and V) through a ring of 4 stages
//    with full / empty mbarriers. TMA fills rows past the end with zeros;
//  - S^T = K Q^T and dP^T = V dO^T (dQ: S = Q K^T, dP = dO V^T) are wgmma
//    m64n64k16 with both operands K-major in shared memory;
//  - P^T and dS^T (dQ: dS) stay in registers: the fp32 accumulator fragment,
//    packed as hi and lo, is the A operand of dV += P^T dO and dK += dS^T Q
//    (dQ += dS K), wgmma m64n64k16 from registers with dO, Q (K) read
//    MN-major from the same swizzled tiles. No logits, P or dS pass through
//    shared memory, and no CTA-wide barrier runs inside the loop;
//  - overlap: a consumer issues tile i's S^T, dP^T and then tile i-1's dV,
//    dK products before it waits for the first two, so tile i's FP32 work
//    runs while the tensor cores do tile i-1's four split products; the
//    other consumer's products fill the tensor cores while this one waits.
//    Measured no faster on the H100 and not kept: the consumers taking turns
//    to issue (ping-pong), three dQ consumers (192 q rows at 160 registers),
//    and the fixed operands (K, V; or Q, dO) held as register A fragments
//    (dK/dV then spills, dQ runs slower); so did a hi / lo split by bit masks
//    in place of the conversions, so the split's cost is not what bounds it;
//  - epilogue: dK (x scale), dV and dQ (x scale) rounded to the input type and
//    written from registers through the output strides, tail rows dropped.
//
// C interface (bound with ctypes): sa_flash_attention_bwd_dkv and
// sa_flash_attention_bwd_dq return the cudaError_t of the launch
// (cudaGetLastError), 0 on success, and cudaErrorInvalidValue for a shape
// they do not take or a layout whose tensor map the CUDA driver refuses.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using sm90::ex2;
using sm90::LOG2E;

constexpr int D = 64;                            // head dim
constexpr int C = 2;                             // consumer warpgroups, 64 rows each
constexpr int ROWS = 64 * C;                     // rows a CTA owns: kv (dK/dV), q (dQ)
constexpr int BN = 64;                           // rows of a streamed tile: q (dK/dV), kv (dQ)
constexpr int STAGES = 4;                        // ring depth
constexpr int NTHREADS = 128 * (C + 1);          // and one producer warpgroup
constexpr uint32_t ROW_BYTES = D * 2;            // one 16-bit row: the 128-byte swizzle span
constexpr uint32_t TILE_BYTES = 64 * ROW_BYTES;  // 64 rows: a streamed tile, a consumer's share
constexpr uint32_t OWN_BYTES = ROWS * ROW_BYTES;
constexpr uint32_t VEC_BYTES = BN * 4;           // one tile's lse or delta
// 1024 bytes of slack to align the swizzled tiles, the tiles, (lse, delta),
// the mbarriers
constexpr size_t DKV_SMEM =
    1024 + 2 * OWN_BYTES + 2 * STAGES * TILE_BYTES + 2 * STAGES * VEC_BYTES + 8 * (1 + 2 * STAGES);
constexpr size_t DQ_SMEM = 1024 + 2 * OWN_BYTES + 2 * STAGES * TILE_BYTES + 8 * (1 + 2 * STAGES);
// registers per thread: __launch_bounds__(384, 1) gives 65536 / 384 rounded
// down to 8 at launch; setmaxnreg moves them from the producer to the
// consumers (ptxas must report this count: at fewer, the consumers'
// setmaxnreg.inc would wait forever)
constexpr int LAUNCH_REGS = 65536 / NTHREADS / 8 * 8;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
static_assert(128 * PRODUCER_REGS + 128 * C * CONSUMER_REGS <= NTHREADS * LAUNCH_REGS,
              "setmaxnreg asks for more registers than the CTA holds");
static_assert(DKV_SMEM <= 232448 && DQ_SMEM <= 232448, "shared memory");

struct Params {
  const float* lse;    // [B, H, Sq_pad]
  const float* delta;  // [B, H, Sq_pad]
  void* dq;
  void* dk;
  void* dv;
  int sq, sk, h;
  // strides (batch, seq, head) of dQ, dK, dV
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  float scale;
};

template <typename T>
struct Ops;

template <>
struct Ops<__nv_bfloat16> {
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
struct Ops<__half> {
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

// x (fp32, an m64n64 accumulator fragment) as the A fragments of four k16
// steps, hi = round(x) and lo = round(x - hi): the accumulator's layout is
// the A operand's, pairs of neighbouring columns in one register
template <typename T>
__device__ __forceinline__ void split(const float (&x)[32], uint32_t (&hi)[16],
                                      uint32_t (&lo)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    float h0, h1;
    hi[i] = Ops<T>::pack(x[2 * i], x[2 * i + 1]);
    Ops<T>::unpack(hi[i], h0, h1);
    lo[i] = Ops<T>::pack(x[2 * i] - h0, x[2 * i + 1] - h1);
  }
}

// acc = A B^T over d = 64, A and B 64-row tiles K-major in shared memory;
// issued, not committed
template <typename T>
__device__ __forceinline__ void issue_ss(float (&acc)[32], const unsigned char* a,
                                         const unsigned char* b) {
  const uint64_t desc_a = sm90::desc_sw128(a, 16, 1024);
  const uint64_t desc_b = sm90::desc_sw128(b, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)  // k16 steps: 32 bytes along the rows
    sm90::wgmma_ss_m64n64k16<T>(acc, desc_a + 2 * kk, desc_b + 2 * kk, kk > 0);
}

// acc += X B, X = hi + lo the A fragments of a 64 x 64 fp32 fragment and B a
// 64-row tile read MN-major; issued, not committed
template <typename T>
__device__ __forceinline__ void issue_rs(float (&acc)[32], const uint32_t (&hi)[16],
                                         const uint32_t (&lo)[16], const unsigned char* b) {
  // 8-row groups 1024 bytes apart (one 64-wide group along d, so the other
  // offset is unused)
  const uint64_t desc_b = sm90::desc_sw128(b, 1024, 1024);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {  // k16 steps: 16 rows of 128 bytes
    sm90::wgmma_rs_m64n64k16_tn<T>(acc, hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2],
                                   hi[4 * kk + 3], desc_b + 128 * kk);
    sm90::wgmma_rs_m64n64k16_tn<T>(acc, lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2],
                                   lo[4 * kk + 3], desc_b + 128 * kk);
  }
}

// rows `row` and `row` + 8 of an m64n64 fragment (columns 8n + 2t, + 1) times
// `mul`, rounded to T, into a [S, 64] slice; rows at or past `valid` dropped
template <typename T>
__device__ __forceinline__ void store_rows(void* out, long long row_stride, int valid, int row,
                                           int t, const float (&acc)[32], float mul) {
  T* base = reinterpret_cast<T*>(out);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + 2 * t;
    if (row < valid)
      *reinterpret_cast<uint32_t*>(base + (long long)row * row_stride + col) =
          Ops<T>::pack(acc[4 * n] * mul, acc[4 * n + 1] * mul);
    if (row + 8 < valid)
      *reinterpret_cast<uint32_t*>(base + (long long)(row + 8) * row_stride + col) =
          Ops<T>::pack(acc[4 * n + 2] * mul, acc[4 * n + 3] * mul);
  }
}

// dK/dV: P^T and dS^T in place of S^T (s) and dP^T (dp), whose columns are
// the q rows of one tile; lse and delta of those rows in shared memory; q rows
// at or past `valid` get P = 0
__device__ __forceinline__ void p_ds_cols(float (&s)[32], float (&dp)[32], const float* lse,
                                          const float* delta, int valid, int t, float scale_log2e) {
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
    const int c = 8 * n + 2 * t;
    const float2 l = *reinterpret_cast<const float2*>(lse + c);
    const float2 dl = *reinterpret_cast<const float2*>(delta + c);
    const float l0 = l.x * LOG2E, l1 = l.y * LOG2E;
    float p[4] = {ex2(fmaf(s[4 * n], scale_log2e, -l0)), ex2(fmaf(s[4 * n + 1], scale_log2e, -l1)),
                  ex2(fmaf(s[4 * n + 2], scale_log2e, -l0)),
                  ex2(fmaf(s[4 * n + 3], scale_log2e, -l1))};
    if (c >= valid) p[0] = p[2] = 0.f;
    if (c + 1 >= valid) p[1] = p[3] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dp[4 * n + e] = p[e] * (dp[4 * n + e] - ((e & 1) ? dl.y : dl.x));
      s[4 * n + e] = p[e];
    }
  }
}

// dQ: dS in place of S (s), whose rows are this thread's two q rows (lse
// pre-multiplied by log2 e) and columns the kv rows of one tile; kv rows at or
// past `valid` get P = 0
__device__ __forceinline__ void ds_rows(float (&s)[32], const float (&dp)[32], float lse_lo,
                                        float lse_hi, float dl_lo, float dl_hi, int valid, int t,
                                        float scale_log2e) {
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
    const int c = 8 * n + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pv = (c + (e & 1)) < valid
                           ? ex2(fmaf(s[4 * n + e], scale_log2e, -(e < 2 ? lse_lo : lse_hi)))
                           : 0.f;
      s[4 * n + e] = pv * (dp[4 * n + e] - (e < 2 ? dl_lo : dl_hi));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sK = smem;
  unsigned char* sV = sK + OWN_BYTES;
  unsigned char* sQ = sV + OWN_BYTES;
  unsigned char* sdO = sQ + STAGES * TILE_BYTES;
  float* sLse = reinterpret_cast<float*>(sdO + STAGES * TILE_BYTES);
  float* sDelta = sLse + STAGES * BN;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sDelta + STAGES * BN);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int k0 = blockIdx.x * ROWS;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int n_q = (p.sq + BN - 1) / BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      sm90::mbar_init(&full[st], 1);
      sm90::mbar_init(&empty[st], C * 4);  // one arrival per consumer warp
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread loads K, V and keeps the q-tile ring full
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      sm90::prefetch_tensormap(&tm_q);
      sm90::prefetch_tensormap(&tm_do);
      const long long vec0 = ((long long)bb * p.h + hh) * (n_q * BN);
      sm90::mbar_arrive_expect_tx(kv_full, 2 * OWN_BYTES);
      sm90::tma_load_4d(sK, &tm_k, kv_full, 0, k0, hh, bb);
      sm90::tma_load_4d(sV, &tm_v, kv_full, 0, k0, hh, bb);
      for (int i = 0; i < n_q; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) sm90::mbar_wait(&empty[st], ((i / STAGES) - 1) & 1);
        sm90::mbar_arrive_expect_tx(&full[st], 2 * TILE_BYTES + 2 * VEC_BYTES);
        sm90::tma_load_4d(sQ + st * TILE_BYTES, &tm_q, &full[st], 0, i * BN, hh, bb);
        sm90::tma_load_4d(sdO + st * TILE_BYTES, &tm_do, &full[st], 0, i * BN, hh, bb);
        sm90::bulk_load(sLse + st * BN, p.lse + vec0 + i * BN, VEC_BYTES, &full[st]);
        sm90::bulk_load(sDelta + st * BN, p.delta + vec0 + i * BN, VEC_BYTES, &full[st]);
      }
    }
  } else {
    // consumer warpgroup cw: kv rows k0 + 64 cw .. + 63
    sm90::setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;  // fragment row (and row + 8) within the warp's 16
    const int t = lane % 4;  // fragment column pair
    const unsigned char* sKw = sK + cw * TILE_BYTES;
    const unsigned char* sVw = sV + cw * TILE_BYTES;
    const float scale_log2e = p.scale * LOG2E;

    float s[32], dp[32], dk[32], dv[32];
    uint32_t p_hi[16], p_lo[16], ds_hi[16], ds_lo[16];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

    sm90::mbar_wait(kv_full, 0);
    sm90::mbar_wait(&full[0], 0);
    sm90::wgmma_fence();
    issue_ss<T>(s, sKw, sQ);     // S^T = K Q^T
    issue_ss<T>(dp, sVw, sdO);   // dP^T = V dO^T
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(s);
    sm90::fence_operands(dp);
    p_ds_cols(s, dp, sLse, sDelta, p.sq, t, scale_log2e);
    split<T>(s, p_hi, p_lo);
    split<T>(dp, ds_hi, ds_lo);
    for (int i = 1; i < n_q; ++i) {
      const int st = i % STAGES;
      const int prev = (i - 1) % STAGES;
      sm90::mbar_wait(&full[st], (i / STAGES) & 1);
      sm90::wgmma_fence();
      issue_ss<T>(s, sKw, sQ + st * TILE_BYTES);
      issue_ss<T>(dp, sVw, sdO + st * TILE_BYTES);
      sm90::wgmma_commit();
      issue_rs<T>(dv, p_hi, p_lo, sdO + prev * TILE_BYTES);  // dV += P^T dO
      issue_rs<T>(dk, ds_hi, ds_lo, sQ + prev * TILE_BYTES);  // dK += dS^T Q
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // tile i's S^T, dP^T are in; tile i-1's products run on
      sm90::fence_operands(s);
      sm90::fence_operands(dp);
      p_ds_cols(s, dp, sLse + st * BN, sDelta + st * BN, p.sq - i * BN, t, scale_log2e);
      sm90::wgmma_wait<0>();
      sm90::fence_operands(dv);
      sm90::fence_operands(dk);
      if (lane == 0) sm90::mbar_arrive(&empty[prev]);
      split<T>(s, p_hi, p_lo);
      split<T>(dp, ds_hi, ds_lo);
    }
    const int last = (n_q - 1) % STAGES;
    sm90::wgmma_fence();
    issue_rs<T>(dv, p_hi, p_lo, sdO + last * TILE_BYTES);
    issue_rs<T>(dk, ds_hi, ds_lo, sQ + last * TILE_BYTES);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(dv);
    sm90::fence_operands(dk);

    const int row = k0 + cw * 64 + warp * 16 + g;
    store_rows<T>(static_cast<T*>(p.dk) + bb * p.dk_sb + hh * p.dk_sh, p.dk_ss, p.sk, row, t, dk,
                  p.scale);
    store_rows<T>(static_cast<T*>(p.dv) + bb * p.dv_sb + hh * p.dv_sh, p.dv_ss, p.sk, row, t, dv,
                  1.f);
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;
  unsigned char* sdO = sQ + OWN_BYTES;
  unsigned char* sK = sdO + OWN_BYTES;
  unsigned char* sV = sK + STAGES * TILE_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + STAGES * TILE_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int q0 = blockIdx.x * ROWS;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int n_kv = (p.sk + BN - 1) / BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      sm90::mbar_init(&full[st], 1);
      sm90::mbar_init(&empty[st], C * 4);  // one arrival per consumer warp
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread loads Q, dO and keeps the kv-tile ring full
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      sm90::prefetch_tensormap(&tm_k);
      sm90::prefetch_tensormap(&tm_v);
      sm90::mbar_arrive_expect_tx(q_full, 2 * OWN_BYTES);
      sm90::tma_load_4d(sQ, &tm_q, q_full, 0, q0, hh, bb);
      sm90::tma_load_4d(sdO, &tm_do, q_full, 0, q0, hh, bb);
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % STAGES;
        if (j >= STAGES) sm90::mbar_wait(&empty[st], ((j / STAGES) - 1) & 1);
        sm90::mbar_arrive_expect_tx(&full[st], 2 * TILE_BYTES);
        sm90::tma_load_4d(sK + st * TILE_BYTES, &tm_k, &full[st], 0, j * BN, hh, bb);
        sm90::tma_load_4d(sV + st * TILE_BYTES, &tm_v, &full[st], 0, j * BN, hh, bb);
      }
    }
  } else {
    // consumer warpgroup cw: q rows q0 + 64 cw .. + 63
    sm90::setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const unsigned char* sQw = sQ + cw * TILE_BYTES;
    const unsigned char* sdOw = sdO + cw * TILE_BYTES;
    const float scale_log2e = p.scale * LOG2E;

    // lse (times log2 e) and delta of this thread's two q rows
    const int row = q0 + cw * 64 + warp * 16 + g;
    const long long vec0 = ((long long)bb * p.h + hh) * ((p.sq + BN - 1) / BN * BN);
    const float lse_lo = row < p.sq ? p.lse[vec0 + row] * LOG2E : 0.f;
    const float lse_hi = row + 8 < p.sq ? p.lse[vec0 + row + 8] * LOG2E : 0.f;
    const float dl_lo = row < p.sq ? p.delta[vec0 + row] : 0.f;
    const float dl_hi = row + 8 < p.sq ? p.delta[vec0 + row + 8] : 0.f;

    float s[32], dp[32], dq[32];
    uint32_t ds_hi[16], ds_lo[16];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.f;

    sm90::mbar_wait(q_full, 0);
    sm90::mbar_wait(&full[0], 0);
    sm90::wgmma_fence();
    issue_ss<T>(s, sQw, sK);     // S = Q K^T
    issue_ss<T>(dp, sdOw, sV);   // dP = dO V^T
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(s);
    sm90::fence_operands(dp);
    ds_rows(s, dp, lse_lo, lse_hi, dl_lo, dl_hi, p.sk, t, scale_log2e);
    split<T>(s, ds_hi, ds_lo);
    for (int j = 1; j < n_kv; ++j) {
      const int st = j % STAGES;
      const int prev = (j - 1) % STAGES;
      sm90::mbar_wait(&full[st], (j / STAGES) & 1);
      sm90::wgmma_fence();
      issue_ss<T>(s, sQw, sK + st * TILE_BYTES);
      issue_ss<T>(dp, sdOw, sV + st * TILE_BYTES);
      sm90::wgmma_commit();
      issue_rs<T>(dq, ds_hi, ds_lo, sK + prev * TILE_BYTES);  // dQ += dS K
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // tile j's S, dP are in; tile j-1's dS K runs on
      sm90::fence_operands(s);
      sm90::fence_operands(dp);
      ds_rows(s, dp, lse_lo, lse_hi, dl_lo, dl_hi, p.sk - j * BN, t, scale_log2e);
      sm90::wgmma_wait<0>();
      sm90::fence_operands(dq);
      if (lane == 0) sm90::mbar_arrive(&empty[prev]);
      split<T>(s, ds_hi, ds_lo);
    }
    const int last = (n_kv - 1) % STAGES;
    sm90::wgmma_fence();
    issue_rs<T>(dq, ds_hi, ds_lo, sK + last * TILE_BYTES);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(dq);

    store_rows<T>(static_cast<T*>(p.dq) + bb * p.dq_sb + hh * p.dq_sh, p.dq_ss, p.sq, row, t, dq,
                  p.scale);
  }
}

template <typename T>
cudaError_t launch(bool dkv, const void* q, const void* k, const void* v, const void* dout,
                   const long long* st, const Params& p, int b, cudaStream_t stream) {
  using sm90::make_map;
  constexpr bool is_half = std::is_same<T, __half>::value;
  // the CTA's own rows in one box, the streamed tiles in 64-row boxes
  const int q_rows = dkv ? BN : ROWS;
  const int kv_rows = dkv ? ROWS : BN;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!make_map(&tm_q, q, is_half, p.sq, p.h, b, st[0], st[1], st[2], q_rows) ||
      !make_map(&tm_k, k, is_half, p.sk, p.h, b, st[3], st[4], st[5], kv_rows) ||
      !make_map(&tm_v, v, is_half, p.sk, p.h, b, st[6], st[7], st[8], kv_rows) ||
      !make_map(&tm_do, dout, is_half, p.sq, p.h, b, st[9], st[10], st[11], q_rows))
    return cudaErrorInvalidValue;
  auto kernel = dkv ? &flash_bwd_dkv_sm90_kernel<T> : &flash_bwd_dq_sm90_kernel<T>;
  const size_t smem = dkv ? DKV_SMEM : DQ_SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((dkv ? p.sk : p.sq) + ROWS - 1) / ROWS, p.h, b);
  kernel<<<grid, NTHREADS, smem, stream>>>(tm_q, tm_k, tm_v, tm_do, p);
  return cudaGetLastError();
}

int run(bool dkv, const void* q, const void* k, const void* v, const void* dout, const void* lse,
        const void* delta, void* dq, void* dk, void* dv, int dtype, int b, int sq, int sk, int h,
        int d, const void* strides, float scale, void* stream) {
  if (d != D || b > 65535 || h > 65535 || sq <= 0 || sk <= 0) return (int)cudaErrorInvalidValue;
  // strides (batch, seq, head) of q, k, v, dO, dQ, dK, dV
  const long long* st = static_cast<const long long*>(strides);
  Params p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.sq = sq;
  p.sk = sk;
  p.h = h;
  long long* dst[9] = {&p.dq_sb, &p.dq_ss, &p.dq_sh, &p.dk_sb, &p.dk_ss,
                       &p.dk_sh, &p.dv_sb, &p.dv_ss, &p.dv_sh};
  for (int i = 0; i < 9; ++i) *dst[i] = st[12 + i];
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<__nv_bfloat16>(dkv, q, k, v, dout, st, p, b, s);
  if (dtype == 1) return (int)launch<__half>(dkv, q, k, v, dout, st, p, b, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int sa_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dq, void* dk, void* dv, int dtype, int b, int sq,
                                          int sk, int h, int d, const void* strides, float scale,
                                          void* stream) {
  return run(true, q, k, v, dout, lse, delta, dq, dk, dv, dtype, b, sq, sk, h, d, strides, scale,
             stream);
}

extern "C" int sa_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, const void* delta,
                                         void* dq, void* dk, void* dv, int dtype, int b, int sq,
                                         int sk, int h, int d, const void* strides, float scale,
                                         void* stream) {
  return run(false, q, k, v, dout, lse, delta, dq, dk, dv, dtype, b, sq, sk, h, d, strides, scale,
             stream);
}
