// The d = 64 flash-attention forward for Hopper (sm_90a), bf16 / fp16: the
// CTA program that the streamed kernel (csrc/flash_attention_fwd.cu, one CTA
// per q tile) and the resident one (csrc/flash_attention_resident.cu, a
// cluster of CTAs that share every K/V tile) both run, `attend<T, CLUSTER>`,
// with its tile sizes and products (the online softmax is csrc/sm90.cuh's).
// The source notes of the two kernels say what bounds them and why they are
// built so.
//
// One CTA takes BQ = 192 q rows of one (batch, head) and four warpgroups: a
// producer, whose one thread issues the TMA loads (Q once, then 128-key K and
// V tiles into a ring of STAGES stages with full / empty mbarriers), and
// three consumers of 64 q rows, which run S = Q K^T (wgmma m64n128k16 from
// shared memory), the online softmax in registers and O += P V (wgmma
// m64n64k16, P from registers, V MN-major), taking turns to issue (ping-pong
// on named barriers), and store O / l by TMA and lse from registers.
//
// CLUSTER = 1 is the streamed kernel. CLUSTER > 1 runs the CTA in a cluster
// of that many CTAs along x, the q tiles of one (batch, head), which share
// every K/V tile by multicast: the resident kernel's note says how its
// barriers keep the cluster in step.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace d64 {

constexpr int D = 64;
constexpr int BK = 128;                       // keys per kv tile
constexpr int CONSUMERS = 3;                  // consumer warpgroups, 64 q rows each
constexpr int BQ = 64 * CONSUMERS;            // q rows per CTA
constexpr int STAGES = 4;                     // K/V ring depth
constexpr int NTHREADS = 128 * (CONSUMERS + 1);  // and one producer warpgroup
constexpr uint32_t ROW_BYTES = D * 2;         // one 16-bit row: the 128-byte swizzle span
constexpr uint32_t Q_BYTES = BQ * ROW_BYTES;
constexpr uint32_t WG_Q_BYTES = 64 * ROW_BYTES;
constexpr uint32_t KV_BYTES = BK * ROW_BYTES;
// 1024 bytes of slack to align the swizzled tiles, the tiles, the mbarriers
constexpr size_t SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 3 * STAGES);
// registers per thread after setmaxnreg: 128 * 24 + 384 * 160 fit in the
// 512 * 128 that __launch_bounds__(512, 1) gives the CTA at launch
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 160;

struct Params {
  float* lse;  // [B, Sq, H] fp32, or null
  int sq, sk, h;
  float scale;
};

using sm90::Cvt;
using sm90::pack_p;
using sm90::softmax_tile;

// S = Q K^T for one kv tile, issued and committed, not waited for
template <typename T>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint64_t desc_q, const unsigned char* k_tile) {
  const uint64_t desc_k = sm90::desc_sw128(k_tile, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)  // k16 steps: 32 bytes along the rows
    sm90::wgmma_ss_m64n128k16<T>(s, desc_q + 2 * kk, desc_k + 2 * kk, kk > 0);
  sm90::wgmma_commit();
}

// O += P V for one kv tile, issued and committed, not waited for
template <typename T>
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&pa)[32],
                                         const unsigned char* v_tile) {
  // MN-major: 8-key groups 1024 bytes apart (one 64-wide group along d, so
  // the other offset is unused)
  const uint64_t desc_v = sm90::desc_sw128(v_tile, 1024, 1024);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)  // k16 steps: 16 rows of 128 bytes
    sm90::wgmma_rs_m64n64k16_tn<T>(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                                   desc_v + 128 * kk);
  sm90::wgmma_commit();
}

// The CTA program: q rows blockIdx.x * BQ .. + BQ - 1 of head blockIdx.y,
// batch blockIdx.z, in a cluster of CLUSTER CTAs along x (see the note at the
// top). `smem_raw` is the kernel's dynamic shared memory, SMEM bytes; the
// maps are __grid_constant__ kernel parameters.
template <typename T, int CLUSTER>
__device__ __forceinline__ void attend(unsigned char* smem_raw, const CUtensorMap* tm_q,
                                       const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                       const CUtensorMap* tm_o, const Params& p) {
  static_assert(CLUSTER >= 1 && CLUSTER <= 8 && (CLUSTER & (CLUSTER - 1)) == 0, "cluster size");
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;
  unsigned char* sK = sQ + Q_BYTES;
  unsigned char* sV = sK + STAGES * KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + STAGES * KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int q0 = blockIdx.x * BQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int n_kv = (p.sk + BK - 1) / BK;
  const int wg = threadIdx.x / 128;
  // in a cluster, a CTA past the q tail has no rows (CLUSTER = 1 never has)
  const bool has_rows = CLUSTER == 1 || q0 < p.sq;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      sm90::mbar_init(&k_full[st], 1);
      sm90::mbar_init(&v_full[st], 1);
      // one arrival per consumer warp of the cluster
      sm90::mbar_init(&empty[st], CLUSTER * CONSUMERS * 4);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();
  // in a cluster, every thread arrives now and waits before its first
  // multicast or remote arrival, so that every CTA's barriers exist by then
  if constexpr (CLUSTER > 1) sm90::cluster_arrive();

  if (wg == 0) {
    // producer: one thread keeps the K/V ring full
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      const int rank = CLUSTER == 1 ? 0 : (int)sm90::cluster_ctarank();
      // tile j at key j * BK into a stage: this CTA's own, or, in a
      // cluster, the owner's load multicast to every CTA
      auto load = [&](unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int j) {
        if constexpr (CLUSTER == 1)
          sm90::tma_load_4d(dst, map, bar, 0, j * BK, hh, bb);
        else if (j % CLUSTER == rank)
          sm90::tma_load_4d_multicast(dst, map, bar, (1u << CLUSTER) - 1, 0, j * BK, hh, bb);
      };
      sm90::prefetch_tensormap(tm_k);
      sm90::prefetch_tensormap(tm_v);
      if (has_rows) {
        sm90::mbar_arrive_expect_tx(q_full, Q_BYTES);
        sm90::tma_load_4d(sQ, tm_q, q_full, 0, q0, hh, bb);
      }
      if constexpr (CLUSTER > 1) sm90::cluster_wait();
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % STAGES;
        // the stage is free once every consumer warp of the cluster left it
        if (j >= STAGES) sm90::mbar_wait(&empty[st], ((j / STAGES) - 1) & 1);
        // every CTA expects the whole tile, whichever CTA loads it
        sm90::mbar_arrive_expect_tx(&k_full[st], KV_BYTES);
        load(sK + st * KV_BYTES, tm_k, &k_full[st], j);
        sm90::mbar_arrive_expect_tx(&v_full[st], KV_BYTES);
        load(sV + st * KV_BYTES, tm_v, &v_full[st], j);
      }
    } else if constexpr (CLUSTER > 1) {
      sm90::cluster_wait();
    }
    // this thread's multicasts are issued: the end barrier's arrival
    if constexpr (CLUSTER > 1) sm90::cluster_arrive();
  } else {
    // consumer warpgroup cw: q rows q0 + 64 cw .. + 63
    sm90::setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;  // fragment row (and row + 8) within the warp's 16
    const int t = lane % 4;  // fragment column pair
    unsigned char* sQw = sQ + cw * WG_Q_BYTES;
    // this warp has read the stage: one arrival on its empty barrier in every
    // CTA of the cluster
    auto release = [&](int st) {
      if constexpr (CLUSTER == 1) {
        if (lane == 0) sm90::mbar_arrive(&empty[st]);
      } else {
        if (lane < CLUSTER) sm90::mbar_arrive_cluster(&empty[st], lane);
      }
    };

    if (!has_rows) {
      // no q rows: let every tile land here (peers write this CTA's stages)
      // and release it as the consumers of a CTA with rows do
      sm90::cluster_wait();
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % STAGES;
        sm90::mbar_wait(&k_full[st], (j / STAGES) & 1);
        sm90::mbar_wait(&v_full[st], (j / STAGES) & 1);
        if (j + 1 < n_kv) release(st);
      }
      sm90::cluster_arrive();
    } else {
      // q * scale in fp32, rounded to T, in place (elementwise: the swizzle
      // does not matter), then made visible to wgmma
      sm90::mbar_wait(q_full, 0);
#pragma unroll
      for (int i = 0; i < (int)(WG_Q_BYTES / 16 / 128); ++i) {
        uint4* chunk = reinterpret_cast<uint4*>(sQw) + tid + 128 * i;
        uint4 raw = *chunk;
        T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int x = 0; x < 8; ++x) e[x] = Cvt<T>::from_f(Cvt<T>::to_f(e[x]) * p.scale);
        *chunk = raw;
      }
      sm90::fence_proxy_async();
      sm90::named_bar_sync(1 + cw, 128);

      const uint64_t desc_q = sm90::desc_sw128(sQw, 16, 1024);
      // ping-pong: the consumers issue their wgmmas in turn, so that one's
      // softmax runs under the others' products. Named barrier CONSUMERS + 1 +
      // cw is this warpgroup's turn, completed by its sync and the previous
      // warpgroup's arrival; the first turn is warpgroup 0's, and the last
      // warpgroup makes no arrival after its last turn, so every arrival is
      // matched.
      const int turn_bar = CONSUMERS + 1 + cw;
      const int next_bar = CONSUMERS + 1 + (cw + 1) % CONSUMERS;
      auto take_turn = [&] { sm90::named_bar_sync(turn_bar, 256); };
      auto pass_turn = [&](bool last) {
        if (!(last && cw == CONSUMERS - 1)) sm90::named_bar_arrive(next_bar, 256);
      };
      if (cw == CONSUMERS - 1) sm90::named_bar_arrive(next_bar, 256);
      float s[64];
      float o[32];
      uint32_t pa[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      float m_lo = -INFINITY, m_hi = -INFINITY;
      float l_lo = 0.f, l_hi = 0.f;
      float a_lo, a_hi;

      take_turn();
      sm90::mbar_wait(&k_full[0], 0);
      sm90::wgmma_fence();
      issue_qk<T>(s, desc_q, sK);
      pass_turn(false);
      sm90::wgmma_wait<0>();
      sm90::fence_operands(s);
      softmax_tile(s, p.sk, t, m_lo, m_hi, l_lo, l_hi, a_lo, a_hi);
      pack_p<T>(s, pa);
      if constexpr (CLUSTER > 1) sm90::cluster_wait();  // before the first release
      for (int j = 1; j < n_kv; ++j) {
        const int st = j % STAGES;
        const int prev = (j - 1) % STAGES;
        take_turn();
        sm90::mbar_wait(&k_full[st], (j / STAGES) & 1);
        sm90::wgmma_fence();
        issue_qk<T>(s, desc_q, sK + st * KV_BYTES);
        sm90::mbar_wait(&v_full[prev], ((j - 1) / STAGES) & 1);
        issue_pv<T>(o, pa, sV + prev * KV_BYTES);
        pass_turn(false);
        sm90::wgmma_wait<1>();  // tile j's logits are in; tile j-1's P V runs on
        sm90::fence_operands(s);
        softmax_tile(s, p.sk - j * BK, t, m_lo, m_hi, l_lo, l_hi, a_lo, a_hi);
        sm90::wgmma_wait<0>();
        sm90::fence_operands(o);
        release(prev);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[4 * n] *= a_lo;
          o[4 * n + 1] *= a_lo;
          o[4 * n + 2] *= a_hi;
          o[4 * n + 3] *= a_hi;
        }
        pack_p<T>(s, pa);
      }
      // the last release is made: the end barrier's arrival
      if constexpr (CLUSTER > 1) sm90::cluster_arrive();
      const int last = (n_kv - 1) % STAGES;
      take_turn();
      sm90::mbar_wait(&v_full[last], ((n_kv - 1) / STAGES) & 1);
      sm90::wgmma_fence();
      issue_pv<T>(o, pa, sV + last * KV_BYTES);
      pass_turn(true);
      sm90::wgmma_wait<0>();
      sm90::fence_operands(o);

      // epilogue: l summed over the quad; O / l rounded to T into this warp's
      // own Q rows, 128-byte swizzled as the output map expects, then one TMA
      // store per warpgroup
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
        l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
      }
      const int r_lo = warp * 16 + g;
      const int r_hi = r_lo + 8;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(sQw + r_lo * ROW_BYTES + ((n ^ (r_lo & 7)) << 4) + 4 * t) =
            Cvt<T>::pack(o[4 * n] / l_lo, o[4 * n + 1] / l_lo);
        *reinterpret_cast<uint32_t*>(sQw + r_hi * ROW_BYTES + ((n ^ (r_hi & 7)) << 4) + 4 * t) =
            Cvt<T>::pack(o[4 * n + 2] / l_hi, o[4 * n + 3] / l_hi);
      }
      sm90::fence_proxy_async();
      sm90::named_bar_sync(1 + cw, 128);
      const int row0 = q0 + cw * 64;
      if (tid == 0 && row0 < p.sq) {
        sm90::tma_store_4d(tm_o, sQw, 0, row0, hh, bb);
        sm90::tma_store_wait();
      }
      if (p.lse != nullptr && t == 0) {
        if (row0 + r_lo < p.sq)
          p.lse[((long long)bb * p.sq + row0 + r_lo) * p.h + hh] = m_lo + logf(l_lo);
        if (row0 + r_hi < p.sq)
          p.lse[((long long)bb * p.sq + row0 + r_hi) * p.h + hh] = m_hi + logf(l_hi);
      }
    }
  }
  // no CTA leaves while a peer may still load into its shared memory or
  // arrive on its barriers: every thread of the cluster has arrived once its
  // multicasts and remote arrivals were issued
  if constexpr (CLUSTER > 1) sm90::cluster_wait();
}

}  // namespace d64
