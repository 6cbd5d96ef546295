// The d = 512 flash-attention backward pair for Hopper (sm_90a), bf16 / fp16:
// flash_bwd_dkv_d512_sm90_kernel and flash_bwd_dq_d512_sm90_kernel, driven
// from csrc/flash_attention_bwd.cu (sa_flash_attention_bwd_dkv_d512 /
// _dq_d512), whose source note gives the function both pairs compute. Head
// dim 512 is the VAE decoder's mid attention, differentiated by the face
// optimisation (pipeline/face_opt.py) once its latent crop holds 512 or more
// tokens.
//
// Replaces, at d = 512, the TPU kernels stableanimator_tpu/ops/
// flash_attention.py::_bwd_dkv_kernel and ::_bwd_dq_kernel.
//
// What bounds it. The function's own work is 8 B H Sq Sk d operations
// (dK/dV: S^T, dP^T, dV, dK) and 6 B H Sq Sk d (dQ: S, dP, dQ), far above the
// card's ~295 operations a byte at the face-opt shapes (576 and 1024 tokens),
// so the tensor cores bound it. P and dS are fp32 and enter the 16-bit tensor
// cores as two parts (hi = round(x), lo = round(x - hi); grad_tolerance rests
// on it), which doubles the dV, dK and dQ products. In products of
// 2 B H Sq Sk d operations the pair issues 8 (dK/dV: S^T and dP^T once for
// each of its 2 column slices, dV and dK hi and lo) and 4 (dQ: S, dP, dQ hi
// and lo), against the function's 4 and 3.
//
// What is hard at d = 512. One [64, 512] fp32 accumulator is 128 KB, the
// register file of an SM holds 256 KB, and dK and dV together are 256 KB; a
// [64, 512] 16-bit tile is 64 KB of the 227 KB of shared memory a block has.
// So the CTA program is the d = 512 forward's (csrc/flash_fwd_d512.cuh): 384
// threads, a producer warpgroup, whose one thread issues every TMA load and
// whose registers setmaxnreg hands to the others (24 left), and two consumer
// warpgroups (240) that split d.
//   dQ: one CTA per (64 q rows, head, batch). Consumer c owns
//     dQ[:, 256c .. 256c + 255] (128 fp32 registers, as the forward's O).
//   dK/dV: one CTA per (64 kv rows, one half (256) of the output columns,
//     head, batch). Consumer c owns dK and dV over 128 of those columns
//     (64 + 64 fp32 registers).
// The CTA's own rows (Q and dO, or K and V) are loaded once, 8 swizzled
// 64-column TMA boxes each (128 KB); BN = 16-row tiles of the other two
// stream through two rings with full and empty mbarriers. A tile is read by
// its own S and dP and by its dQ (dK, dV) products, which run under the
// next tile's FP32 work; so the operand of those products (dQ: K; dK/dV:
// the half of Q and dO whose columns the CTA's slice covers) has a ring of
// LONG_STAGES = 3, and the rest (dQ: V; dK/dV: the other half, read by one
// consumer's S^T / dP^T only) of SHORT_STAGES = 2. With one ring of 2 stages
// for everything, the load of tile j + 1 could start only when tile j - 1's
// products were done, and its latency showed in every tile: 28 % (dQ) and
// 22 % (dK/dV, with its products issued first) of the time on the H100.
// lse and delta come by 1-D bulk copy of the [B, H, Sq_pad] vectors, with
// the dK/dV kernel's kept half.
//   - S and dP (dK/dV: S^T = K Q^T and dP^T = V dO^T) with the reduction
//     over d split: consumer c issues its half (wgmma m64n16k16, both
//     operands K-major in shared memory, 16 k16 steps each, S's and dP's
//     interleaved), writes both
//     fp32 partials to shared memory, and after a named barrier of the two
//     adds the other's; a second barrier guards the buffer. fp32 addition
//     commutes, so both hold the same S and dP bit for bit.
//   - P = exp(S scale - lse) (expf: ex2.approx was too coarse for
//     grad_tolerance at d = 512), dS = P (dP - delta), P = 0 past the kv
//     tail (dQ) or the q tail (dK/dV); P and dS stay in registers, split
//     hi + lo as register A fragments of dQ_c += dS K[:, half c] (wgmma
//     m64n256k16, K read MN-major) or dV_c += P^T dO[:, cols c] and
//     dK_c += dS^T Q[:, cols c] (m64n128k16, dO and Q read MN-major).
//   - A consumer issues tile j's S and dP, then tile j-1's products, and
//     waits for the first, so the exchange and tile j's FP32 work run while
//     the tensor cores do the products.
//   - Epilogue: dQ scale, dK scale and dV rounded to the input type and
//     written from registers through the output strides, tail rows dropped.
//     No atomics: each output element is summed by one CTA in a fixed
//     order, so the result is the same from run to run.
//
// Budgets. Shared memory: the own rows 131,072 bytes, the rings 5 x 16,384,
// the exchange 2 consumers x 8,192 (S and dP partials of 64 x 16 fp32), 1 KB
// to align the swizzled tiles, the barriers (and for dK/dV lse and delta):
// 230,488 (dQ) and 230,872 (dK/dV) of 232,448. 32-row tiles leave room for
// one stage only. The small-N trap: the S / dP products have N = 16, so a
// wgmma moves 2 KB of A and 512 B of B out of shared memory for 32 K
// operations, ~13 a byte against the ~32 a byte the tensor cores need at
// ~128 bytes a clock of shared memory per SM: they run far below the peak,
// but cutting them to a quarter saved only ~19 % of the time on the H100.
// Registers: ptxas must report the launch-bound count, 168 at 384 threads,
// with no spills (setmaxnreg.inc waits forever at fewer). Waves at crop 32:
// dQ 256 CTAs (1.94 waves on 132 SMs), dK/dV 512 (3.9); at crop 24 dQ has
// 144, so its second wave is 9 % full.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace bwd512 {

constexpr int D = 512;
constexpr int CONSUMERS = 2;                     // consumer warpgroups, splitting d
constexpr int HALF = D / CONSUMERS;              // head-dim columns per consumer's S, dP
constexpr int BM = 64;                           // rows a CTA owns: q (dQ), kv (dK/dV)
constexpr int BN = 16;                           // rows of a streamed tile: kv (dQ), q (dK/dV)
// ring depths: LONG for the streamed operand that the next tile's products
// still read (dQ: K; dK/dV: the half of Q and dO whose columns the CTA's
// slice covers), SHORT for the rest (dQ: V; dK/dV: the other half)
constexpr int LONG_STAGES = 3;
constexpr int SHORT_STAGES = 2;
constexpr int NTHREADS = 128 * (CONSUMERS + 1);  // and one producer warpgroup
constexpr int BLOCKS = D / 64;                   // 64-column swizzled blocks of a row
constexpr int DKV_SLICES = 2;                    // output column slices of dK/dV
constexpr int DKV_COLS = D / DKV_SLICES / CONSUMERS;  // dK / dV columns per consumer
constexpr int VEC_TILE = 64;                     // lse / delta rows are padded to whole 64s
constexpr uint32_t OWN_BLOCK_BYTES = BM * 128;
constexpr uint32_t TILE_BLOCK_BYTES = BN * 128;
constexpr uint32_t OWN_BYTES = BLOCKS * OWN_BLOCK_BYTES;
constexpr uint32_t TILE_BYTES = BLOCKS * TILE_BLOCK_BYTES;
constexpr uint32_t HALF_TILE_BYTES = TILE_BYTES / 2;  // a tile's half of d
constexpr uint32_t X_BYTES = 2 * BM * BN * 4;    // one consumer's fp32 partials of S and dP
constexpr uint32_t VEC_BYTES = BN * 4;           // one tile's lse or delta
// 1024 bytes of slack to align the swizzled tiles, the own rows, the two
// rings (dQ: K and V tiles; dK/dV: the Q and dO halves), the partials, (dK/dV:
// lse and delta per LONG stage) and the mbarriers (own rows; full / empty
// per stage of each ring)
constexpr size_t DQ_SMEM = 1024 + 2 * OWN_BYTES + (LONG_STAGES + SHORT_STAGES) * TILE_BYTES +
                           CONSUMERS * X_BYTES + 8 * (1 + 2 * LONG_STAGES + 2 * SHORT_STAGES);
constexpr size_t DKV_SMEM = DQ_SMEM + 2 * LONG_STAGES * VEC_BYTES;
// registers per thread: __launch_bounds__(384, 1) gives 65536 / 384 rounded
// down to 8 at launch; setmaxnreg moves them from the producer to the
// consumers (ptxas must report this count: at fewer, the consumers'
// setmaxnreg.inc would wait forever)
constexpr int LAUNCH_REGS = 65536 / NTHREADS / 8 * 8;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
static_assert(128 * PRODUCER_REGS + 128 * CONSUMERS * CONSUMER_REGS <= NTHREADS * LAUNCH_REGS,
              "setmaxnreg asks for more registers than the CTA holds");
static_assert(DQ_SMEM <= 232448 && DKV_SMEM <= 232448, "shared memory");
// named barrier of both consumers (0 is __syncthreads)
constexpr int EXCHANGE = 1;

struct Params {
  const float* lse;    // [B, H, Sq_pad] fp32
  const float* delta;  // [B, H, Sq_pad] fp32
  void* dq;
  void* dk;
  void* dv;
  int sq, sk, h;
  // strides (batch, seq, head) of dQ, dK, dV
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  float scale;
};

// S_c = A_s B_s^T and dP_c = A_dp B_dp^T over one half of d for a 16-row
// tile: each A the CTA's own 64 rows, each B the streamed tile, all K-major
// in shared memory from the half's first block; 16 k16 steps each, 4 in each
// of the half's 64-column blocks, the two products' steps interleaved;
// issued, not committed
template <typename T>
__device__ __forceinline__ void issue_logits(float (&s)[8], float (&dp)[8],
                                             const unsigned char* a_s, const unsigned char* b_s,
                                             const unsigned char* a_dp,
                                             const unsigned char* b_dp) {
  const uint64_t desc_as = sm90::desc_sw128(a_s, 16, 1024);
  const uint64_t desc_bs = sm90::desc_sw128(b_s, 16, 1024);
  const uint64_t desc_adp = sm90::desc_sw128(a_dp, 16, 1024);
  const uint64_t desc_bdp = sm90::desc_sw128(b_dp, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < HALF / 16; ++kk) {
    // block kk / 4, then 32 bytes along the rows per step (descriptor units
    // of 16 bytes)
    const uint64_t a_off = ((kk / 4) * OWN_BLOCK_BYTES + (kk % 4) * 32) >> 4;
    const uint64_t b_off = ((kk / 4) * TILE_BLOCK_BYTES + (kk % 4) * 32) >> 4;
    sm90::wgmma_ss_m64n16k16<T>(s, desc_as + a_off, desc_bs + b_off, kk > 0);
    sm90::wgmma_ss_m64n16k16<T>(dp, desc_adp + a_off, desc_bdp + b_off, kk > 0);
  }
}

__device__ __forceinline__ void add4(float (&r)[8], int i, float4 x) {
  r[i] += x.x;
  r[i + 1] += x.y;
  r[i + 2] += x.z;
  r[i + 3] += x.w;
}

// S = S_0 + S_1 and dP = dP_0 + dP_1: this consumer's partials to shared
// memory, the barrier of the two, the other's added, and a second barrier
// before either writes its next partials
__device__ __forceinline__ void exchange(float (&s)[8], float (&dp)[8], unsigned char* sx, int cw,
                                         int tid) {
  float4* mine = reinterpret_cast<float4*>(sx + cw * X_BYTES);
  const float4* other = reinterpret_cast<const float4*>(sx + (1 - cw) * X_BYTES);
  mine[tid] = make_float4(s[0], s[1], s[2], s[3]);
  mine[128 + tid] = make_float4(s[4], s[5], s[6], s[7]);
  mine[256 + tid] = make_float4(dp[0], dp[1], dp[2], dp[3]);
  mine[384 + tid] = make_float4(dp[4], dp[5], dp[6], dp[7]);
  sm90::named_bar_sync(EXCHANGE, 128 * CONSUMERS);
  add4(s, 0, other[tid]);
  add4(s, 4, other[128 + tid]);
  add4(dp, 0, other[256 + tid]);
  add4(dp, 4, other[384 + tid]);
  sm90::named_bar_sync(EXCHANGE, 128 * CONSUMERS);
}

// the 64-column blocks b0 .. b0 + n - 1 of rows r0 .. of head hh, batch bb
// into dst (`block` bytes apart), completing on one barrier
__device__ __forceinline__ void load_rows(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, uint32_t block, int r0, int hh, int bb,
                                          int b0 = 0, int n = BLOCKS) {
  for (int i = 0; i < n; ++i)
    sm90::tma_load_4d(dst + i * block, map, bar, 64 * (b0 + i), r0, hh, bb);
}

// dQ: dS in place of S, whose rows are this thread's two q rows and
// columns the tile's kv rows; kv rows at or past `valid` get P = 0
__device__ __forceinline__ void ds_rows(float (&s)[8], const float (&dp)[8], float lse_lo,
                                        float lse_hi, float dl_lo, float dl_hi, int valid, int t,
                                        float scale) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int col = 8 * (e / 4) + 2 * t + (e & 1);
    const bool lo = (e & 2) == 0;
    const float pv = col < valid ? expf(s[e] * scale - (lo ? lse_lo : lse_hi)) : 0.f;
    s[e] = pv * (dp[e] - (lo ? dl_lo : dl_hi));
  }
}

// dK/dV: P^T and dS^T in place of S^T (s) and dP^T (dp), whose columns are
// the tile's q rows; lse and delta of those rows in shared memory; q rows at
// or past `valid` get P = 0
__device__ __forceinline__ void p_ds_cols(float (&s)[8], float (&dp)[8], const float* lse,
                                          const float* delta, int valid, int t, float scale) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int col = 8 * (e / 4) + 2 * t + (e & 1);
    const float pv = col < valid ? expf(s[e] * scale - lse[col]) : 0.f;
    dp[e] = pv * (dp[e] - delta[col]);
    s[e] = pv;
  }
}

// dQ_c += dS K[:, half c] for one tile, hi then lo, K read MN-major (the
// half's four 64-column blocks the leading byte offset apart); issued, not
// committed
template <typename T>
__device__ __forceinline__ void issue_dq(float (&acc)[128], const uint32_t (&hi)[4],
                                         const uint32_t (&lo)[4], const unsigned char* k_half) {
  const uint64_t desc_k = sm90::desc_sw128(k_half, TILE_BLOCK_BYTES, 1024);
  sm90::wgmma_rs_m64n256k16_tn<T>(acc, hi[0], hi[1], hi[2], hi[3], desc_k);
  sm90::wgmma_rs_m64n256k16_tn<T>(acc, lo[0], lo[1], lo[2], lo[3], desc_k);
}

// dV_c += P^T dO[:, cols c] and dK_c += dS^T Q[:, cols c] for one tile, hi
// then lo, dO and Q read MN-major from the consumer's first column block
// (two 64-column blocks the leading byte offset apart); issued, not
// committed
template <typename T>
__device__ __forceinline__ void issue_dkv(float (&dv)[64], float (&dk)[64],
                                          const uint32_t (&p_hi)[4], const uint32_t (&p_lo)[4],
                                          const uint32_t (&ds_hi)[4], const uint32_t (&ds_lo)[4],
                                          const unsigned char* do_cols,
                                          const unsigned char* q_cols) {
  const uint64_t desc_do = sm90::desc_sw128(do_cols, TILE_BLOCK_BYTES, 1024);
  const uint64_t desc_q = sm90::desc_sw128(q_cols, TILE_BLOCK_BYTES, 1024);
  sm90::wgmma_rs_m64n128k16_tn<T>(dv, p_hi[0], p_hi[1], p_hi[2], p_hi[3], desc_do);
  sm90::wgmma_rs_m64n128k16_tn<T>(dv, p_lo[0], p_lo[1], p_lo[2], p_lo[3], desc_do);
  sm90::wgmma_rs_m64n128k16_tn<T>(dk, ds_hi[0], ds_hi[1], ds_hi[2], ds_hi[3], desc_q);
  sm90::wgmma_rs_m64n128k16_tn<T>(dk, ds_lo[0], ds_lo[1], ds_lo[2], ds_lo[3], desc_q);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dq_d512_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                                  const __grid_constant__ CUtensorMap tm_k,
                                  const __grid_constant__ CUtensorMap tm_v,
                                  const __grid_constant__ CUtensorMap tm_do, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;
  unsigned char* sdO = sQ + OWN_BYTES;
  unsigned char* sK = sdO + OWN_BYTES;
  unsigned char* sV = sK + LONG_STAGES * TILE_BYTES;
  unsigned char* sX = sV + SHORT_STAGES * TILE_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sX + CONSUMERS * X_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + LONG_STAGES;
  uint64_t* v_full = k_empty + LONG_STAGES;
  uint64_t* v_empty = v_full + SHORT_STAGES;

  const int q0 = blockIdx.x * BM;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int n_kv = (p.sk + BN - 1) / BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    // empty barriers: one arrival per consumer warp
    for (int st = 0; st < LONG_STAGES; ++st) {
      sm90::mbar_init(&k_full[st], 1);
      sm90::mbar_init(&k_empty[st], CONSUMERS * 4);
    }
    for (int st = 0; st < SHORT_STAGES; ++st) {
      sm90::mbar_init(&v_full[st], 1);
      sm90::mbar_init(&v_empty[st], CONSUMERS * 4);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread loads Q, dO and keeps the K and V rings full
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      sm90::prefetch_tensormap(&tm_k);
      sm90::prefetch_tensormap(&tm_v);
      sm90::mbar_arrive_expect_tx(q_full, 2 * OWN_BYTES);
      load_rows(sQ, &tm_q, q_full, OWN_BLOCK_BYTES, q0, hh, bb);
      load_rows(sdO, &tm_do, q_full, OWN_BLOCK_BYTES, q0, hh, bb);
      for (int j = 0; j < n_kv; ++j) {
        const int ks = j % LONG_STAGES;
        if (j >= LONG_STAGES) sm90::mbar_wait(&k_empty[ks], ((j / LONG_STAGES) - 1) & 1);
        sm90::mbar_arrive_expect_tx(&k_full[ks], TILE_BYTES);
        load_rows(sK + ks * TILE_BYTES, &tm_k, &k_full[ks], TILE_BLOCK_BYTES, j * BN, hh, bb);
        const int vs = j % SHORT_STAGES;
        if (j >= SHORT_STAGES) sm90::mbar_wait(&v_empty[vs], ((j / SHORT_STAGES) - 1) & 1);
        sm90::mbar_arrive_expect_tx(&v_full[vs], TILE_BYTES);
        load_rows(sV + vs * TILE_BYTES, &tm_v, &v_full[vs], TILE_BLOCK_BYTES, j * BN, hh, bb);
      }
    }
  } else {
    // consumer warpgroup cw: dQ[:, 256 cw .. 256 cw + 255]
    sm90::setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;  // fragment row (and row + 8) within the warp's 16
    const int t = lane % 4;  // fragment column pair
    const uint32_t own_half = cw * (BLOCKS / CONSUMERS) * OWN_BLOCK_BYTES;
    const uint32_t tile_half = cw * (BLOCKS / CONSUMERS) * TILE_BLOCK_BYTES;
    // lse and delta of this thread's two q rows
    const int row = q0 + warp * 16 + g;
    const long long vec0 =
        ((long long)bb * p.h + hh) * ((p.sq + VEC_TILE - 1) / VEC_TILE * VEC_TILE);
    const float lse_lo = row < p.sq ? p.lse[vec0 + row] : 0.f;
    const float lse_hi = row + 8 < p.sq ? p.lse[vec0 + row + 8] : 0.f;
    const float dl_lo = row < p.sq ? p.delta[vec0 + row] : 0.f;
    const float dl_hi = row + 8 < p.sq ? p.delta[vec0 + row + 8] : 0.f;

    const float scale = p.scale;

    float s[8], dp[8], dq[128];
    uint32_t ds_hi[4], ds_lo[4];
#pragma unroll
    for (int i = 0; i < 128; ++i) dq[i] = 0.f;

    sm90::mbar_wait(q_full, 0);
    sm90::mbar_wait(&k_full[0], 0);
    sm90::mbar_wait(&v_full[0], 0);
    sm90::wgmma_fence();
    // S_c = Q K^T, dP_c = dO V^T
    issue_logits<T>(s, dp, sQ + own_half, sK + tile_half, sdO + own_half, sV + tile_half);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(s);
    sm90::fence_operands(dp);
    if (lane == 0) sm90::mbar_arrive(&v_empty[0]);  // this warp has read V
    exchange(s, dp, sX, cw, tid);
    ds_rows(s, dp, lse_lo, lse_hi, dl_lo, dl_hi, p.sk, t, scale);
    sm90::split<T>(s, ds_hi, ds_lo);
    for (int j = 1; j < n_kv; ++j) {
      const int ks = j % LONG_STAGES;
      const int vs = j % SHORT_STAGES;
      const int prev = (j - 1) % LONG_STAGES;
      sm90::mbar_wait(&k_full[ks], (j / LONG_STAGES) & 1);
      sm90::mbar_wait(&v_full[vs], (j / SHORT_STAGES) & 1);
      sm90::wgmma_fence();
      issue_logits<T>(s, dp, sQ + own_half, sK + ks * TILE_BYTES + tile_half, sdO + own_half,
                      sV + vs * TILE_BYTES + tile_half);
      sm90::wgmma_commit();
      issue_dq<T>(dq, ds_hi, ds_lo, sK + prev * TILE_BYTES + tile_half);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // tile j's partials are in; tile j-1's dS K runs on
      sm90::fence_operands(s);
      sm90::fence_operands(dp);
      if (lane == 0) sm90::mbar_arrive(&v_empty[vs]);
      exchange(s, dp, sX, cw, tid);
      ds_rows(s, dp, lse_lo, lse_hi, dl_lo, dl_hi, p.sk - j * BN, t, scale);
      sm90::wgmma_wait<0>();
      sm90::fence_operands(dq);
      if (lane == 0) sm90::mbar_arrive(&k_empty[prev]);
      sm90::split<T>(s, ds_hi, ds_lo);
    }
    const int last = (n_kv - 1) % LONG_STAGES;
    sm90::wgmma_fence();
    issue_dq<T>(dq, ds_hi, ds_lo, sK + last * TILE_BYTES + tile_half);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(dq);

    sm90::store_rows<T>(static_cast<T*>(p.dq) + bb * p.dq_sb + hh * p.dq_sh + HALF * cw, p.dq_ss,
                        p.sq, row, t, dq, p.scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dkv_d512_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                                   const __grid_constant__ CUtensorMap tm_k,
                                   const __grid_constant__ CUtensorMap tm_v,
                                   const __grid_constant__ CUtensorMap tm_do, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  // the Q and dO tiles in two rings by halves of d: `kept`, the half whose
  // columns this CTA's slice covers (read by one consumer's S^T / dP^T and
  // by both consumers' dK / dV products, which run into the next tile), and
  // `passing`, the other half (read by the other consumer's S^T / dP^T only)
  unsigned char* sK = smem;
  unsigned char* sV = sK + OWN_BYTES;
  unsigned char* sQ_kept = sV + OWN_BYTES;
  unsigned char* sdO_kept = sQ_kept + LONG_STAGES * HALF_TILE_BYTES;
  unsigned char* sQ_pass = sdO_kept + LONG_STAGES * HALF_TILE_BYTES;
  unsigned char* sdO_pass = sQ_pass + SHORT_STAGES * HALF_TILE_BYTES;
  unsigned char* sX = sdO_pass + SHORT_STAGES * HALF_TILE_BYTES;
  float* sLse = reinterpret_cast<float*>(sX + CONSUMERS * X_BYTES);
  float* sDelta = sLse + LONG_STAGES * BN;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sDelta + LONG_STAGES * BN);
  uint64_t* kept_full = kv_full + 1;
  uint64_t* kept_empty = kept_full + LONG_STAGES;
  uint64_t* pass_full = kept_empty + LONG_STAGES;
  uint64_t* pass_empty = pass_full + SHORT_STAGES;

  const int k0 = blockIdx.x * BM;
  const int hh = blockIdx.y / DKV_SLICES;
  const int slice = blockIdx.y % DKV_SLICES;  // the kept half of d
  const int bb = blockIdx.z;
  const int n_q = (p.sq + BN - 1) / BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    // empty barriers: one arrival per consumer warp that reads the ring
    for (int st = 0; st < LONG_STAGES; ++st) {
      sm90::mbar_init(&kept_full[st], 1);
      sm90::mbar_init(&kept_empty[st], CONSUMERS * 4);
    }
    for (int st = 0; st < SHORT_STAGES; ++st) {
      sm90::mbar_init(&pass_full[st], 1);
      sm90::mbar_init(&pass_empty[st], 4);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread loads K, V and keeps both rings full
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      sm90::prefetch_tensormap(&tm_q);
      sm90::prefetch_tensormap(&tm_do);
      const long long vec0 =
          ((long long)bb * p.h + hh) * ((p.sq + VEC_TILE - 1) / VEC_TILE * VEC_TILE);
      const int kept0 = slice * (BLOCKS / 2), pass0 = (1 - slice) * (BLOCKS / 2);
      sm90::mbar_arrive_expect_tx(kv_full, 2 * OWN_BYTES);
      load_rows(sK, &tm_k, kv_full, OWN_BLOCK_BYTES, k0, hh, bb);
      load_rows(sV, &tm_v, kv_full, OWN_BLOCK_BYTES, k0, hh, bb);
      for (int i = 0; i < n_q; ++i) {
        const int ls = i % LONG_STAGES;
        if (i >= LONG_STAGES) sm90::mbar_wait(&kept_empty[ls], ((i / LONG_STAGES) - 1) & 1);
        sm90::mbar_arrive_expect_tx(&kept_full[ls], TILE_BYTES + 2 * VEC_BYTES);
        load_rows(sQ_kept + ls * HALF_TILE_BYTES, &tm_q, &kept_full[ls], TILE_BLOCK_BYTES, i * BN,
                  hh, bb, kept0, BLOCKS / 2);
        load_rows(sdO_kept + ls * HALF_TILE_BYTES, &tm_do, &kept_full[ls], TILE_BLOCK_BYTES,
                  i * BN, hh, bb, kept0, BLOCKS / 2);
        sm90::bulk_load(sLse + ls * BN, p.lse + vec0 + i * BN, VEC_BYTES, &kept_full[ls]);
        sm90::bulk_load(sDelta + ls * BN, p.delta + vec0 + i * BN, VEC_BYTES, &kept_full[ls]);
        const int ps = i % SHORT_STAGES;
        if (i >= SHORT_STAGES) sm90::mbar_wait(&pass_empty[ps], ((i / SHORT_STAGES) - 1) & 1);
        sm90::mbar_arrive_expect_tx(&pass_full[ps], TILE_BYTES);
        load_rows(sQ_pass + ps * HALF_TILE_BYTES, &tm_q, &pass_full[ps], TILE_BLOCK_BYTES, i * BN,
                  hh, bb, pass0, BLOCKS / 2);
        load_rows(sdO_pass + ps * HALF_TILE_BYTES, &tm_do, &pass_full[ps], TILE_BLOCK_BYTES,
                  i * BN, hh, bb, pass0, BLOCKS / 2);
      }
    }
  } else {
    // consumer warpgroup cw: S^T and dP^T over half cw of d; dK and dV over
    // columns 256 slice + 128 cw .. + 127
    sm90::setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const uint32_t own_half = cw * (BLOCKS / CONSUMERS) * OWN_BLOCK_BYTES;
    const bool kept = cw == slice;  // this consumer's half of d is the kept one
    const int col0 = (DKV_SLICES * slice + cw) * DKV_COLS;  // this consumer's output columns
    const uint32_t cols = cw * (DKV_COLS / 64) * TILE_BLOCK_BYTES;  // their blocks in the kept half
    const float scale = p.scale;
    // this consumer's half of the Q and dO tiles, in one ring or the other
    const unsigned char* sQ_half = kept ? sQ_kept : sQ_pass;
    const unsigned char* sdO_half = kept ? sdO_kept : sdO_pass;

    float s[8], dp[8], dk[64], dv[64];
    uint32_t p_hi[4], p_lo[4], ds_hi[4], ds_lo[4];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

    sm90::mbar_wait(kv_full, 0);
    sm90::mbar_wait(&kept_full[0], 0);
    if (!kept) sm90::mbar_wait(&pass_full[0], 0);
    sm90::wgmma_fence();
    // S^T_c = K Q^T, dP^T_c = V dO^T
    issue_logits<T>(s, dp, sK + own_half, sQ_half, sV + own_half, sdO_half);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(s);
    sm90::fence_operands(dp);
    if (!kept && lane == 0) sm90::mbar_arrive(&pass_empty[0]);
    exchange(s, dp, sX, cw, tid);
    p_ds_cols(s, dp, sLse, sDelta, p.sq, t, scale);
    sm90::split<T>(s, p_hi, p_lo);
    sm90::split<T>(dp, ds_hi, ds_lo);
    for (int i = 1; i < n_q; ++i) {
      const int ls = i % LONG_STAGES;
      const int ps = i % SHORT_STAGES;
      const int prev = (i - 1) % LONG_STAGES;
      sm90::mbar_wait(&kept_full[ls], (i / LONG_STAGES) & 1);
      if (!kept) sm90::mbar_wait(&pass_full[ps], (i / SHORT_STAGES) & 1);
      const uint32_t off = (kept ? ls : ps) * HALF_TILE_BYTES;
      sm90::wgmma_fence();
      issue_logits<T>(s, dp, sK + own_half, sQ_half + off, sV + own_half, sdO_half + off);
      sm90::wgmma_commit();
      issue_dkv<T>(dv, dk, p_hi, p_lo, ds_hi, ds_lo, sdO_kept + prev * HALF_TILE_BYTES + cols,
                   sQ_kept + prev * HALF_TILE_BYTES + cols);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // tile i's partials are in; tile i-1's products run on
      sm90::fence_operands(s);
      sm90::fence_operands(dp);
      if (!kept && lane == 0) sm90::mbar_arrive(&pass_empty[ps]);
      exchange(s, dp, sX, cw, tid);
      p_ds_cols(s, dp, sLse + ls * BN, sDelta + ls * BN, p.sq - i * BN, t, scale);
      sm90::wgmma_wait<0>();
      sm90::fence_operands(dv);
      sm90::fence_operands(dk);
      if (lane == 0) sm90::mbar_arrive(&kept_empty[prev]);
      sm90::split<T>(s, p_hi, p_lo);
      sm90::split<T>(dp, ds_hi, ds_lo);
    }
    const int last = (n_q - 1) % LONG_STAGES;
    sm90::wgmma_fence();
    issue_dkv<T>(dv, dk, p_hi, p_lo, ds_hi, ds_lo, sdO_kept + last * HALF_TILE_BYTES + cols,
                 sQ_kept + last * HALF_TILE_BYTES + cols);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(dv);
    sm90::fence_operands(dk);

    const int row = k0 + warp * 16 + g;
    sm90::store_rows<T>(static_cast<T*>(p.dk) + bb * p.dk_sb + hh * p.dk_sh + col0, p.dk_ss, p.sk,
                        row, t, dk, scale);
    sm90::store_rows<T>(static_cast<T*>(p.dv) + bb * p.dv_sb + hh * p.dv_sh + col0, p.dv_ss, p.sk,
                        row, t, dv, 1.f);
  }
}

// launches the dK/dV (dkv) or the dQ kernel for one input type: tensor maps
// over q, k, v, dO (strides `st`: batch, seq, head of each) with boxes of the
// CTA's own 64 rows or of a 16-row streamed tile
template <typename T>
cudaError_t launch(bool dkv, const void* q, const void* k, const void* v, const void* dout,
                   const long long* st, const Params& p, int b, cudaStream_t stream) {
  constexpr bool is_half = std::is_same<T, __half>::value;
  const int q_rows = dkv ? BN : BM;
  const int kv_rows = dkv ? BM : BN;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!sm90::make_map(&tm_q, q, is_half, p.sq, p.h, b, st[0], st[1], st[2], q_rows, D) ||
      !sm90::make_map(&tm_k, k, is_half, p.sk, p.h, b, st[3], st[4], st[5], kv_rows, D) ||
      !sm90::make_map(&tm_v, v, is_half, p.sk, p.h, b, st[6], st[7], st[8], kv_rows, D) ||
      !sm90::make_map(&tm_do, dout, is_half, p.sq, p.h, b, st[9], st[10], st[11], q_rows, D))
    return cudaErrorInvalidValue;
  auto kernel = dkv ? &flash_bwd_dkv_d512_sm90_kernel<T> : &flash_bwd_dq_d512_sm90_kernel<T>;
  const size_t smem = dkv ? DKV_SMEM : DQ_SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((dkv ? p.sk : p.sq) + BM - 1) / BM, p.h * (dkv ? DKV_SLICES : 1), b);
  kernel<<<grid, NTHREADS, smem, stream>>>(tm_q, tm_k, tm_v, tm_do, p);
  return cudaGetLastError();
}

}  // namespace bwd512
