// The d = 512 flash-attention backward pair for Hopper (sm_90a), bf16 / fp16:
// flash_bwd_dkv_d512_kernel and flash_bwd_dq_d512_kernel, driven from
// csrc/flash_attention_bwd.cu (sa_flash_attention_bwd_dkv_d512 / _dq_d512),
// whose source note gives the function both pairs compute. Head dim 512 is
// the VAE decoder's mid attention, differentiated by the face optimisation
// (pipeline/face_opt.py) once its latent crop holds 512 or more tokens.
//
// Replaces, at d = 512, the TPU kernels stableanimator_tpu/ops/
// flash_attention.py::_bwd_dkv_kernel and ::_bwd_dq_kernel.
//
// What is hard at d = 512. One [64, 512] fp32 accumulator is 128 KB, the
// register file of a whole SM holds 256 KB, and dK and dV together are
// 256 KB: the d = 64 pair's design (dK and dV for 128 kv rows in two
// consumers' registers) cannot be widened. So each CTA owns a slice of the
// output's columns, and recomputes S and dP, whose reductions run over all
// of d, for its slice:
//   dK/dV: one CTA per (64 kv rows, 128 of the 512 output columns, head,
//     batch); its four warps own 16 kv rows each and hold their rows' dK
//     and dV slices in registers (64 + 64 fp32 a thread) while the CTA
//     streams every 32-row q tile: S^T = K Q^T and dP^T = V dO^T over the
//     whole d (32 k16 steps), P^T and dS^T in registers, then
//     dV[:, slice] += P^T dO[:, slice] and dK[:, slice] += dS^T Q[:, slice].
//   dQ: one CTA per (64 q rows, 256 of the output columns, head, batch),
//     streaming 32-row kv tiles: S = Q K^T, dP = dO V^T over the whole d,
//     dS, dQ[:, slice] += dS K[:, slice] (128 fp32 a thread).
// The CTA's own rows (K and V, or Q and dO: 64 x 512 each) and one streamed
// tile pair (32 x 512 each) sit in shared memory, rows padded by 16 bytes so
// that ldmatrix reads no two rows from one bank: 199,936 bytes, one CTA an SM.
// No atomics: each output element is summed by one CTA in a fixed order, so
// the result is the same from run to run.
//
// What bounds it. The function's own work is 8 B H Sq Sk d operations
// (dK/dV) and 6 B H Sq Sk d (dQ), far above the card's ~295 operations a
// byte at the face-opt shapes (576 and 1024 tokens), so the tensor cores bound
// it. This design issues more: S^T and dP^T once per column slice (4 for
// dK/dV, 2 for dQ), and P and dS, which are fp32, as two 16-bit parts
// (hi = round(x), lo = round(x - hi); grad_tolerance rests on it), which
// doubles the dV, dK and dQ products. In products of 2 B H Sq Sk d
// operations: dK/dV issues 4 x 2 + 2 x 2 = 12, dQ 2 x 2 + 2 = 6 (the
// function: 4 and 3). It is a simple kernel: mma.sync m16n8k16 fed by
// ldmatrix, cp.async loads of one tile at a time with no pipelining, four
// warps an SM; no wgmma, TMA or warp specialisation (the d = 64 pair's
// Hopper design), which is the lever for a later redesign.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace bwd512 {

constexpr int D = 512;
constexpr int LDT = D + 8;          // padded shared row, elements (1040 bytes)
constexpr int NW = 4;               // warps per CTA
constexpr int NTHREADS = 32 * NW;
constexpr int BM = 16 * NW;         // rows a CTA owns: kv (dK/dV), q (dQ)
constexpr int BN = 32;              // rows of a streamed tile: q (dK/dV), kv (dQ)
constexpr int DKV_COLS = 128;       // output columns of a dK/dV CTA
constexpr int DQ_COLS = 256;        // output columns of a dQ CTA
constexpr int DKV_SLICES = D / DKV_COLS;
constexpr int DQ_SLICES = D / DQ_COLS;
constexpr int VEC_TILE = 64;        // lse / delta rows are padded to whole 64s
// the CTA's rows and one streamed tile pair, 16-bit; lse and delta of a tile
constexpr size_t SMEM = (size_t)(2 * BM + 2 * BN) * LDT * 2 + 2 * BN * sizeof(float);
static_assert(SMEM <= 232448, "shared memory");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, Sq_pad] fp32
  const float* delta;  // [B, H, Sq_pad] fp32
  void* dq;
  void* dk;
  void* dv;
  int sq, sk, h;
  // strides (batch, seq, head) of q, k, v, dO, dQ, dK, dV
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  float scale;
};

// c += a b, m16n8k16, fp32 accumulation (not volatile: a function of its
// registers, which the compiler may schedule after later ldmatrix loads)
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  if constexpr (std::is_same<T, __half>::value) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sm90::smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(sm90::smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(sm90::smem_u32(p)));
}

// 16-byte async copy; a row past the end (valid false) fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sm90::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows r0 .. r0 + ROWS - 1 of a [S, 512] slice with row stride `row_stride`
// into a padded [ROWS, LDT] shared tile, zeros past `rows_valid`; issued, not
// waited for
template <typename T, int ROWS>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long row_stride, int r0,
                                          int rows_valid) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks of a row
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    const bool valid = r0 + r < rows_valid;
    cp_async16(dst + r * LDT + c, src + (valid ? (long long)(r0 + r) * row_stride : 0) + c,
               valid);
  }
}

// C[16 x BN] = A[16 x 512] B^T: A the 16 rows of a shared tile from row0, B a
// [BN, 512] shared tile whose rows are C's columns; 32 k16 steps
template <typename T>
__device__ __forceinline__ void product_abt(float (&c)[BN / 8][4], const T* a, int row0,
                                            const T* b, int lane) {
#pragma unroll
  for (int n = 0; n < BN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
  const int mi = lane / 8, rr = lane % 8, l16 = lane % 16;
  const T* a_lane = a + (row0 + rr + (mi & 1) * 8) * LDT + (mi >> 1) * 8;
  const T* b_lane = b + (l16 % 8) * LDT + (l16 / 8) * 8;
#pragma unroll 2
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a_lane + kk * 16);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      uint32_t bf[2];
      ldsm_x2(bf, b_lane + n * 8 * LDT + kk * 16);
      mma<T>(c[n], af, bf);
    }
  }
}

// acc[16 x COLS] += X[16 x BN] B[:, col0 .. col0 + COLS - 1], X the fp32 C
// fragments `x` fed to the tensor cores as hi + lo, B a [BN, 512] shared
// tile (ldmatrix .trans)
template <typename T, int COLS>
__device__ __forceinline__ void product_split(float (&acc)[COLS / 8][4], const float (&x)[BN / 8][4],
                                              const T* b, int col0, int lane) {
  const int l16 = lane % 16;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // the C fragment of n tiles 2kk, 2kk + 1 is the A fragment of k step
      // kk: (row g, tile 2kk), (row g + 8, tile 2kk), (g, 2kk + 1), (g + 8, 2kk + 1)
      const float* src = x[2 * kk + (r >> 1)] + (r & 1) * 2;
      hi[r] = sm90::Cvt<T>::pack(src[0], src[1]);
      const float h0 = sm90::Cvt<T>::to_f(sm90::Cvt<T>::from_f(src[0]));
      const float h1 = sm90::Cvt<T>::to_f(sm90::Cvt<T>::from_f(src[1]));
      lo[r] = sm90::Cvt<T>::pack(src[0] - h0, src[1] - h1);
    }
    const T* b_lane = b + (kk * 16 + l16) * LDT + col0;
#pragma unroll
    for (int n = 0; n < COLS / 8; ++n) {
      uint32_t bf[2];
      ldsm_x2_trans(bf, b_lane + n * 8);
      mma<T>(acc[n], hi, bf);
      mma<T>(acc[n], lo, bf);
    }
  }
}

// rows row0 + g and row0 + g + 8 of a 16 x COLS fragment times `mul`,
// rounded to T, into columns col0 .. of a [S, 512] slice; rows at or past
// `rows_valid` dropped
template <typename T, int COLS>
__device__ __forceinline__ void store_rows(T* base, long long row_stride, int rows_valid, int row0,
                                           int col0, const float (&acc)[COLS / 8][4], float mul,
                                           int lane) {
  const int r_lo = row0 + lane / 4;
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int n = 0; n < COLS / 8; ++n) {
    const int col = col0 + n * 8 + (lane % 4) * 2;
    if (r_lo < rows_valid)
      *reinterpret_cast<uint32_t*>(base + (long long)r_lo * row_stride + col) =
          sm90::Cvt<T>::pack(acc[n][0] * mul, acc[n][1] * mul);
    if (r_hi < rows_valid)
      *reinterpret_cast<uint32_t*>(base + (long long)r_hi * row_stride + col) =
          sm90::Cvt<T>::pack(acc[n][2] * mul, acc[n][3] * mul);
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1) flash_bwd_dkv_d512_kernel(const Params p) {
  extern __shared__ unsigned char smem_d512[];
  T* sK = reinterpret_cast<T*>(smem_d512);
  T* sV = sK + BM * LDT;
  T* sQ = sV + BM * LDT;
  T* sdO = sQ + BN * LDT;
  float* sLse = reinterpret_cast<float*>(sdO + BN * LDT);
  float* sDelta = sLse + BN;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t4 = lane % 4;
  const int k0 = blockIdx.x * BM;
  const int hh = blockIdx.y / DKV_SLICES;
  const int col0 = (blockIdx.y % DKV_SLICES) * DKV_COLS;
  const int bb = blockIdx.z;

  const T* qg = static_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + bb * p.k_sb + hh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + bb * p.v_sb + hh * p.v_sh;
  const T* dog = static_cast<const T*>(p.dout) + bb * p.do_sb + hh * p.do_sh;
  const int sq_pad = (p.sq + VEC_TILE - 1) / VEC_TILE * VEC_TILE;
  const long long vec0 = ((long long)bb * p.h + hh) * sq_pad;

  load_rows<T, BM>(sK, kg, p.k_ss, k0, p.sk);
  load_rows<T, BM>(sV, vg, p.v_ss, k0, p.sk);

  float dk[DKV_COLS / 8][4], dv[DKV_COLS / 8][4];
#pragma unroll
  for (int n = 0; n < DKV_COLS / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int n_q = (p.sq + BN - 1) / BN;
  for (int i = 0; i < n_q; ++i) {
    const int q0 = i * BN;
    __syncthreads();  // the previous q tile is read
    load_rows<T, BN>(sQ, qg, p.q_ss, q0, p.sq);
    load_rows<T, BN>(sdO, dog, p.do_ss, q0, p.sq);
    for (int r = threadIdx.x; r < BN; r += NTHREADS) {
      const bool valid = q0 + r < p.sq;
      sLse[r] = valid ? p.lse[vec0 + q0 + r] : 0.f;
      sDelta[r] = valid ? p.delta[vec0 + q0 + r] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 kv rows; then P^T
    // and dS^T in place, whose columns are q rows (P = 0 past the q tail)
    float st[BN / 8][4], dpt[BN / 8][4];
    product_abt<T>(st, sK, warp * 16, sQ, lane);
    product_abt<T>(dpt, sV, warp * 16, sdO, lane);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + t4 * 2 + (e & 1);
        const float pv = q0 + col < p.sq ? expf(st[n][e] * p.scale - sLse[col]) : 0.f;
        st[n][e] = pv;
        dpt[n][e] = pv * (dpt[n][e] - sDelta[col]);
      }
    }
    product_split<T, DKV_COLS>(dv, st, sdO, col0, lane);   // dV += P^T dO
    product_split<T, DKV_COLS>(dk, dpt, sQ, col0, lane);   // dK += dS^T Q
  }

  T* dkg = static_cast<T*>(p.dk) + bb * p.dk_sb + hh * p.dk_sh;
  T* dvg = static_cast<T*>(p.dv) + bb * p.dv_sb + hh * p.dv_sh;
  store_rows<T, DKV_COLS>(dkg, p.dk_ss, p.sk, k0 + warp * 16, col0, dk, p.scale, lane);
  store_rows<T, DKV_COLS>(dvg, p.dv_ss, p.sk, k0 + warp * 16, col0, dv, 1.f, lane);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1) flash_bwd_dq_d512_kernel(const Params p) {
  extern __shared__ unsigned char smem_d512[];
  T* sQ = reinterpret_cast<T*>(smem_d512);
  T* sdO = sQ + BM * LDT;
  T* sK = sdO + BM * LDT;
  T* sV = sK + BN * LDT;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t4 = lane % 4;
  const int q0 = blockIdx.x * BM;
  const int hh = blockIdx.y / DQ_SLICES;
  const int col0 = (blockIdx.y % DQ_SLICES) * DQ_COLS;
  const int bb = blockIdx.z;

  const T* qg = static_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + bb * p.k_sb + hh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + bb * p.v_sb + hh * p.v_sh;
  const T* dog = static_cast<const T*>(p.dout) + bb * p.do_sb + hh * p.do_sh;

  load_rows<T, BM>(sQ, qg, p.q_ss, q0, p.sq);
  load_rows<T, BM>(sdO, dog, p.do_ss, q0, p.sq);

  // lse and delta of the two q rows this thread's fragments hold
  const int r_lo = q0 + warp * 16 + lane / 4;
  const int r_hi = r_lo + 8;
  const int sq_pad = (p.sq + VEC_TILE - 1) / VEC_TILE * VEC_TILE;
  const long long vec0 = ((long long)bb * p.h + hh) * sq_pad;
  const float lse_lo = r_lo < p.sq ? p.lse[vec0 + r_lo] : 0.f;
  const float lse_hi = r_hi < p.sq ? p.lse[vec0 + r_hi] : 0.f;
  const float dl_lo = r_lo < p.sq ? p.delta[vec0 + r_lo] : 0.f;
  const float dl_hi = r_hi < p.sq ? p.delta[vec0 + r_hi] : 0.f;

  float dq[DQ_COLS / 8][4];
#pragma unroll
  for (int n = 0; n < DQ_COLS / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  const int n_kv = (p.sk + BN - 1) / BN;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // the previous kv tile is read
    load_rows<T, BN>(sK, kg, p.k_ss, k0, p.sk);
    load_rows<T, BN>(sV, vg, p.v_ss, k0, p.sk);
    cp_async_wait_all();
    __syncthreads();

    // S = Q K^T, dP = dO V^T for this warp's 16 q rows; dS in place of S,
    // whose columns are kv rows (P = 0 past the kv tail)
    float s[BN / 8][4], dp[BN / 8][4];
    product_abt<T>(s, sQ, warp * 16, sK, lane);
    product_abt<T>(dp, sdO, warp * 16, sV, lane);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + t4 * 2 + (e & 1);
        const float pv = col < p.sk ? expf(s[n][e] * p.scale - (e < 2 ? lse_lo : lse_hi)) : 0.f;
        s[n][e] = pv * (dp[n][e] - (e < 2 ? dl_lo : dl_hi));
      }
    }
    product_split<T, DQ_COLS>(dq, s, sK, col0, lane);  // dQ += dS K
  }

  T* dqg = static_cast<T*>(p.dq) + bb * p.dq_sb + hh * p.dq_sh;
  store_rows<T, DQ_COLS>(dqg, p.dq_ss, p.sq, q0 + warp * 16, col0, dq, p.scale, lane);
}

// launches the dK/dV (dkv) or the dQ kernel for one input type
template <typename T>
cudaError_t launch(bool dkv, const Params& p, int b, cudaStream_t stream) {
  auto kernel = dkv ? &flash_bwd_dkv_d512_kernel<T> : &flash_bwd_dq_d512_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(((dkv ? p.sk : p.sq) + BM - 1) / BM, p.h * (dkv ? DKV_SLICES : DQ_SLICES), b);
  kernel<<<grid, NTHREADS, SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace bwd512
