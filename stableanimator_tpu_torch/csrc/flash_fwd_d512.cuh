// The d = 512 flash-attention forward for Hopper (sm_90a), bf16 / fp16: the
// CTA program of flash_fwd_d512_sm90_kernel (csrc/flash_attention_fwd.cu),
// `attend<T>`, with its tile sizes, the exchange of the partial logits and
// the products; the kernel's source note says what bounds it and why it is
// built so.
//
// One CTA takes BQ = 64 q rows of one (batch, head) and three warpgroups: a
// producer, whose one thread issues the TMA loads, and two consumers that
// split the head dim. A 64 x 512 fp32 accumulator is 256 registers a thread in one
// warpgroup, so consumer c owns O[:, 256c .. 256c + 255], 128 registers.
//  - Every [rows, 512] tile lives in shared memory as 8 blocks of
//    [rows, 64], each a 128-byte-swizzled TMA box (1024-byte aligned): Q once
//    (64 KB), then BK = 32-key K and V tiles (32 KB each) through a ring of
//    STAGES = 2 stages, with full and empty mbarriers for K and for V apart,
//    so a consumer can hand back K while it still reads V.
//  - S = Q K^T with the reduction split: consumer c issues S_c =
//    Q[:, half c] K[:, half c]^T (wgmma m64n32k16, both operands K-major in
//    shared memory, 16 k16 steps across its 4 blocks), writes its fp32
//    partial to shared memory, and after a barrier of the two adds the
//    other's: S = S_0 + S_1 in both, bit for bit (fp32 addition commutes),
//    so both hold the same S, m, l and P. Each consumer reads only its half
//    of K and of V. The partials are double-buffered by tile parity, so one
//    barrier a tile orders them.
//  - The online softmax on the accumulator fragment in registers
//    (sm90::softmax_tile), P rounded to 16 bits in registers as the A operand
//    of O_c += P V[:, half c]: one wgmma m64n256k16 per k16 step, V read
//    MN-major, its four 64-column blocks the descriptor's leading byte
//    offset apart.
//  - A consumer issues tile j's S_c and tile j-1's P V before it waits for
//    the first, so the exchange and tile j's softmax run while the tensor
//    cores do that P V.
//  - Epilogue: O_c / l, rounded, is staged in the swizzled layout into the
//    consumer's own half of Q (no longer read) and written by four TMA
//    stores, which drop the rows past the q tail; consumer 0 writes lse.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace d512 {

constexpr int D = 512;
constexpr int CONSUMERS = 2;                   // consumer warpgroups, splitting d
constexpr int HALF = D / CONSUMERS;            // head-dim columns per consumer
constexpr int BQ = 64;                         // q rows per CTA
constexpr int BK = 32;                         // keys per kv tile
constexpr int STAGES = 2;                      // K/V ring depth
constexpr int NTHREADS = 128 * (CONSUMERS + 1);  // and one producer warpgroup
constexpr int BLOCKS = D / 64;                 // 64-column swizzled blocks of a row
constexpr uint32_t Q_BLOCK_BYTES = BQ * 128;
constexpr uint32_t KV_BLOCK_BYTES = BK * 128;
constexpr uint32_t Q_BYTES = BLOCKS * Q_BLOCK_BYTES;
constexpr uint32_t KV_BYTES = BLOCKS * KV_BLOCK_BYTES;
constexpr uint32_t X_BYTES = BQ * BK * 4;      // one consumer's fp32 partial logits
// 1024 bytes of slack to align the swizzled tiles, Q, the K and V rings, the
// partials (2 parities x 2 consumers), the mbarriers (Q; K full / empty and
// V full / empty per stage)
constexpr size_t SMEM =
    1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 2 * CONSUMERS * X_BYTES + 8 * (1 + 4 * STAGES);
// registers per thread: __launch_bounds__(384, 1) gives 65536 / 384 rounded
// down to 8 at launch; setmaxnreg moves them from the producer to the
// consumers (ptxas must report this count: at fewer, the consumers'
// setmaxnreg.inc would wait forever)
constexpr int LAUNCH_REGS = 65536 / NTHREADS / 8 * 8;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
static_assert(128 * PRODUCER_REGS + 128 * CONSUMERS * CONSUMER_REGS <= NTHREADS * LAUNCH_REGS,
              "setmaxnreg asks for more registers than the CTA holds");
static_assert(SMEM <= 232448, "shared memory");
// named barriers: 1 + c, consumer c's own 128 threads; EXCHANGE, both consumers
constexpr int EXCHANGE = 1 + CONSUMERS;

struct Params {
  float* lse;  // [B, Sq, H] fp32, or null
  int sq, sk, h;
  float scale;
};

using sm90::Cvt;

// S_c = Q[:, half c] K[:, half c]^T for one kv tile, issued and committed,
// not waited for: 16 k16 steps, 4 in each of the half's 64-column blocks
template <typename T>
__device__ __forceinline__ void issue_qk(float (&s)[16], const unsigned char* q_half,
                                         const unsigned char* k_half) {
  const uint64_t desc_q = sm90::desc_sw128(q_half, 16, 1024);
  const uint64_t desc_k = sm90::desc_sw128(k_half, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < HALF / 16; ++kk) {
    // block kk / 4, then 32 bytes along the rows per step (descriptor units
    // of 16 bytes)
    const uint64_t q_off = ((kk / 4) * Q_BLOCK_BYTES + (kk % 4) * 32) >> 4;
    const uint64_t k_off = ((kk / 4) * KV_BLOCK_BYTES + (kk % 4) * 32) >> 4;
    sm90::wgmma_ss_m64n32k16<T>(s, desc_q + q_off, desc_k + k_off, kk > 0);
  }
  sm90::wgmma_commit();
}

// O_c += P V[:, half c] for one kv tile, issued and committed, not waited
// for: one m64n256k16 per k16 step, V read MN-major (8-key groups 1024 bytes
// apart, the half's four 64-column blocks KV_BLOCK_BYTES apart, a k16 step
// 16 rows of 128 bytes further)
template <typename T>
__device__ __forceinline__ void issue_pv(float (&o)[128], const uint32_t (&pa)[8],
                                         const unsigned char* v_half) {
  const uint64_t desc_v = sm90::desc_sw128(v_half, KV_BLOCK_BYTES, 1024);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    sm90::wgmma_rs_m64n256k16_tn<T>(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                                    desc_v + 128 * kk);
  sm90::wgmma_commit();
}

// The CTA program: q rows blockIdx.x * BQ .. + BQ - 1 of head blockIdx.y,
// batch blockIdx.z (see the note at the top). `smem_raw` is the kernel's
// dynamic shared memory, SMEM bytes; the maps are __grid_constant__ kernel
// parameters over [B, S, H, 512] with boxes of one 64-column block (Q and O:
// BQ rows, K and V: BK rows).
template <typename T>
__device__ __forceinline__ void attend(unsigned char* smem_raw, const CUtensorMap* tm_q,
                                       const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                       const CUtensorMap* tm_o, const Params& p) {
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;
  unsigned char* sK = sQ + Q_BYTES;
  unsigned char* sV = sK + STAGES * KV_BYTES;
  unsigned char* sX = sV + STAGES * KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sX + 2 * CONSUMERS * X_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + STAGES;
  uint64_t* v_full = k_empty + STAGES;
  uint64_t* v_empty = v_full + STAGES;

  const int q0 = blockIdx.x * BQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int n_kv = (p.sk + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      sm90::mbar_init(&k_full[st], 1);
      sm90::mbar_init(&v_full[st], 1);
      // one arrival per consumer warp
      sm90::mbar_init(&k_empty[st], CONSUMERS * 4);
      sm90::mbar_init(&v_empty[st], CONSUMERS * 4);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the K and V rings full
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      // the 8 blocks of kv tile j into its stage, one transaction
      auto load = [&](unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int j) {
#pragma unroll
        for (int i = 0; i < BLOCKS; ++i)
          sm90::tma_load_4d(dst + i * KV_BLOCK_BYTES, map, bar, 64 * i, j * BK, hh, bb);
      };
      sm90::prefetch_tensormap(tm_k);
      sm90::prefetch_tensormap(tm_v);
      sm90::mbar_arrive_expect_tx(q_full, Q_BYTES);
      for (int i = 0; i < BLOCKS; ++i)
        sm90::tma_load_4d(sQ + i * Q_BLOCK_BYTES, tm_q, q_full, 64 * i, q0, hh, bb);
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % STAGES;
        const uint32_t ph = ((j / STAGES) - 1) & 1;
        if (j >= STAGES) sm90::mbar_wait(&k_empty[st], ph);
        sm90::mbar_arrive_expect_tx(&k_full[st], KV_BYTES);
        load(sK + st * KV_BYTES, tm_k, &k_full[st], j);
        if (j >= STAGES) sm90::mbar_wait(&v_empty[st], ph);
        sm90::mbar_arrive_expect_tx(&v_full[st], KV_BYTES);
        load(sV + st * KV_BYTES, tm_v, &v_full[st], j);
      }
    }
  } else {
    // consumer warpgroup cw: O[:, 256 cw .. 256 cw + 255]
    sm90::setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;  // fragment row (and row + 8) within the warp's 16
    const int t = lane % 4;  // fragment column pair
    // this consumer's blocks of Q, and of every K and V tile
    unsigned char* sQc = sQ + cw * (BLOCKS / CONSUMERS) * Q_BLOCK_BYTES;
    const uint32_t kv_half = cw * (BLOCKS / CONSUMERS) * KV_BLOCK_BYTES;
    // this warp has read the stage: one arrival on its empty barrier
    auto release = [&](uint64_t* bar) {
      if (lane == 0) sm90::mbar_arrive(bar);
    };

    // this half of q * scale in fp32, rounded to T, in place (elementwise:
    // the swizzle does not matter), then made visible to wgmma
    sm90::mbar_wait(q_full, 0);
#pragma unroll 4
    for (int i = 0; i < (int)(Q_BYTES / CONSUMERS / 16 / 128); ++i) {
      uint4* chunk = reinterpret_cast<uint4*>(sQc) + tid + 128 * i;
      uint4 raw = *chunk;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int x = 0; x < 8; ++x) e[x] = Cvt<T>::from_f(Cvt<T>::to_f(e[x]) * p.scale);
      *chunk = raw;
    }
    sm90::fence_proxy_async();
    sm90::named_bar_sync(1 + cw, 128);

    // S = S_0 + S_1: this consumer's partial to shared memory (parity
    // `par`), the barrier of the two, the other's added. fp32 addition
    // commutes, so both consumers hold the same S.
    auto exchange = [&](float (&s)[16], int par) {
      float4* mine = reinterpret_cast<float4*>(sX + (2 * par + cw) * X_BYTES);
      const float4* other = reinterpret_cast<const float4*>(sX + (2 * par + 1 - cw) * X_BYTES);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mine[128 * i + tid] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
      sm90::named_bar_sync(EXCHANGE, 128 * CONSUMERS);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x = other[128 * i + tid];
        s[4 * i] += x.x;
        s[4 * i + 1] += x.y;
        s[4 * i + 2] += x.z;
        s[4 * i + 3] += x.w;
      }
    };

    float s[16];
    float o[128];
    uint32_t pa[8];
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] = 0.f;
    float m_lo = -INFINITY, m_hi = -INFINITY;
    float l_lo = 0.f, l_hi = 0.f;
    float a_lo, a_hi;

    sm90::mbar_wait(&k_full[0], 0);
    sm90::wgmma_fence();
    issue_qk<T>(s, sQc, sK + kv_half);
    sm90::wgmma_wait<0>();
    sm90::fence_operands(s);
    release(&k_empty[0]);
    exchange(s, 0);
    sm90::softmax_tile(s, p.sk, t, m_lo, m_hi, l_lo, l_hi, a_lo, a_hi);
    sm90::pack_p<T>(s, pa);
    for (int j = 1; j < n_kv; ++j) {
      const int st = j % STAGES;
      const int prev = (j - 1) % STAGES;
      sm90::mbar_wait(&k_full[st], (j / STAGES) & 1);
      sm90::wgmma_fence();
      issue_qk<T>(s, sQc, sK + st * KV_BYTES + kv_half);
      sm90::mbar_wait(&v_full[prev], ((j - 1) / STAGES) & 1);
      issue_pv<T>(o, pa, sV + prev * KV_BYTES + kv_half);
      sm90::wgmma_wait<1>();  // tile j's partial logits are in; tile j-1's P V runs on
      sm90::fence_operands(s);
      release(&k_empty[st]);
      exchange(s, j & 1);
      sm90::softmax_tile(s, p.sk - j * BK, t, m_lo, m_hi, l_lo, l_hi, a_lo, a_hi);
      sm90::wgmma_wait<0>();
      sm90::fence_operands(o);
      release(&v_empty[prev]);
#pragma unroll
      for (int n = 0; n < HALF / 8; ++n) {
        o[4 * n] *= a_lo;
        o[4 * n + 1] *= a_lo;
        o[4 * n + 2] *= a_hi;
        o[4 * n + 3] *= a_hi;
      }
      sm90::pack_p<T>(s, pa);
    }
    const int last = (n_kv - 1) % STAGES;
    sm90::mbar_wait(&v_full[last], ((n_kv - 1) / STAGES) & 1);
    sm90::wgmma_fence();
    issue_pv<T>(o, pa, sV + last * KV_BYTES + kv_half);
    sm90::wgmma_wait<0>();
    sm90::fence_operands(o);

    // epilogue: l summed over the quad; O_c / l rounded to T into this
    // consumer's own blocks of Q, 128-byte swizzled as the output map
    // expects, then one TMA store per block
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    const int r_lo = warp * 16 + g;
    const int r_hi = r_lo + 8;
#pragma unroll
    for (int n = 0; n < HALF / 8; ++n) {
      unsigned char* blk = sQc + (n / 8) * Q_BLOCK_BYTES;
      const int ch = n % 8;  // 16-byte chunk of the 128-byte row
      *reinterpret_cast<uint32_t*>(blk + r_lo * 128 + ((ch ^ (r_lo & 7)) << 4) + 4 * t) =
          Cvt<T>::pack(o[4 * n] / l_lo, o[4 * n + 1] / l_lo);
      *reinterpret_cast<uint32_t*>(blk + r_hi * 128 + ((ch ^ (r_hi & 7)) << 4) + 4 * t) =
          Cvt<T>::pack(o[4 * n + 2] / l_hi, o[4 * n + 3] / l_hi);
    }
    sm90::fence_proxy_async();
    sm90::named_bar_sync(1 + cw, 128);
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i < BLOCKS / CONSUMERS; ++i)
        sm90::tma_store_4d(tm_o, sQc + i * Q_BLOCK_BYTES, HALF * cw + 64 * i, q0, hh, bb);
      sm90::tma_store_wait();
    }
    if (cw == 0 && p.lse != nullptr && t == 0) {
      float* lse = p.lse + ((long long)bb * p.sq + q0) * p.h + hh;
      if (q0 + r_lo < p.sq) lse[(long long)r_lo * p.h] = m_lo + logf(l_lo);
      if (q0 + r_hi < p.sq) lse[(long long)r_hi * p.h] = m_hi + logf(l_hi);
    }
  }
}

}  // namespace d512
